"""The port's BERT (tfde_tpu_torch/models/bert.py), its MLM step under a
strategy (training/step.make_custom_train_step with `strategy`) and the
entry point (bert_mlm.py), held against the JAX package.

- Logits of `Bert` (with and without a padding mask) and of
  `BertClassifier` on the same weights: fp32 at 1e-5 relative Frobenius;
  a bf16 model within BF16_TOL of the JAX bf16 model (its logits are
  bf16-rounded by the tied decoder: the JAX bf16 model itself lies ~1e-2
  from its fp32 twin); `classifier_params_from_mlm` grafts the trunk.
- Three custom MLM steps (`bert_mlm.mlm_loss_fn`, masked AdamW) against
  the JAX `make_custom_train_step` with the JAX example's loss: at one
  process against one JAX device, and at two gloo ranks under
  MultiWorkerMirroredStrategy against the JAX strategy over two CPU
  devices, on masked batches whose two halves hold different target
  counts (the global normalisation), with `grad_accum` 1 and 2 (both held
  to the JAX full-batch step: accumulation weighted by the target counts
  is the full-batch update). Here the
  JAX fp32 run lies 1.2e-7 (max abs) from its own fp64 run (the model in
  fp64 under x64), and the port 1.2e-7 from the JAX run: no fp64 anchor
  is needed, and the port is held to the JAX run at STEP_ATOL.
- The entry point at `--tiny --device cpu`, and its resume.
"""

import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.overrides import TorchFunctionMode

from tfde_tpu.data import datasets as jdatasets
from tfde_tpu.data import mlm as jmlm
from tfde_tpu.models import bert as jbert
from tfde_tpu.parallel.strategies import MultiWorkerMirroredStrategy
from tfde_tpu.runtime.mesh import make_mesh
from tfde_tpu.training import optimizers as joptim
from tfde_tpu.training.step import init_state as j_init_state
from tfde_tpu.training.step import make_custom_train_step as j_make_step
from tfde_tpu_torch import bert_mlm, testing
from tfde_tpu_torch.models import bert
from tfde_tpu_torch.models.flax_weights import from_flax_params

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from examples import bert_mlm as jbert_mlm  # noqa: E402

#: one intra-op torch thread for the module (`testing.one_thread`)
_one_thread = pytest.fixture(autouse=True, scope="module")(testing.one_thread)

TINY = dict(vocab_size=97, hidden_size=32, depth=2, num_heads=4, mlp_dim=64,
            max_position=64, dropout_rate=0.0)
STEPS, BATCH, SEQ = 3, 16, 32
SCHEDULE = (1e-3, 1, 3)  # peak lr, warmup steps, decay steps
BF16_TOL = 2e-2
#: the port's final parameters against the JAX run's, max abs (measured
#: 1.2e-7, about an ulp at 1)
STEP_ATOL = 1e-6
METRIC_ATOL = 1e-5


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _ids(batch=3, seq=16, seed=0):
    return np.random.default_rng(seed).integers(0, 97, (batch, seq)).astype(
        np.int32)


@functools.cache
def _tiny_params():
    params = jbert.bert_tiny_test().init(
        jax.random.key(0), jnp.asarray(_ids()), train=False)["params"]
    return jax.tree.map(np.asarray, params)


def _port(**kw):
    model = bert.Bert(**{**TINY, "dtype": torch.float32, **kw},
                      device="cpu")
    model.load_state_dict(from_flax_params(_tiny_params()))
    return model


@pytest.mark.parametrize("masked", [False, True])
def test_bert_logits_match_jax(masked):
    ids = _ids()
    am = np.ones(ids.shape, np.float32)
    am[0, 10:] = 0.0
    kw = {"attention_mask": am} if masked else {}
    want = np.asarray(jbert.bert_tiny_test().apply(
        {"params": _tiny_params()}, jnp.asarray(ids),
        **{k: jnp.asarray(v) for k, v in kw.items()}))
    got = _port()(torch.as_tensor(ids),
                  **{k: torch.as_tensor(v) for k, v in kw.items()})
    assert got.dtype == torch.float32 and got.shape == (3, 16, 97)
    assert _rel(got.detach().numpy(), want) <= 1e-5


def test_bert_bf16_logits_match_jax():
    cfg = dict(TINY, hidden_size=128, num_heads=2)
    ids = _ids()
    jm = jbert.Bert(**cfg)
    params = jax.tree.map(np.asarray, jm.init(
        jax.random.key(2), jnp.asarray(ids))["params"])
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(ids)))
    want32 = np.asarray(jbert.Bert(**cfg, dtype=jnp.float32).apply(
        {"params": params}, jnp.asarray(ids)))
    model = bert.Bert(**cfg, device="cpu")
    model.load_state_dict(from_flax_params(params))
    got = model(torch.as_tensor(ids)).detach().numpy()
    print(f"bf16: port vs JAX {_rel(got, want):.3e}; port vs JAX fp32 "
          f"{_rel(got, want32):.3e}; JAX bf16 vs fp32 "
          f"{_rel(want, want32):.3e}")
    assert got.dtype == np.float32
    assert _rel(got, want) <= BF16_TOL
    assert _rel(got, want32) <= 1.5 * _rel(want, want32)


def test_classifier_logits_and_the_graft_match_jax():
    ids = _ids()
    jc = jbert.BertClassifier(num_labels=3, **{**TINY, "dtype": jnp.float32})
    jparams = jax.tree.map(np.asarray, jbert.classifier_params_from_mlm(
        jc, _tiny_params(), jax.random.key(5), jnp.asarray(ids)))
    want = np.asarray(jc.apply({"params": jparams}, jnp.asarray(ids)))
    clf = bert.BertClassifier(num_labels=3, **TINY, dtype=torch.float32,
                              device="cpu")
    own = {k: v.clone() for k, v in clf.state_dict().items()}
    grafted = bert.classifier_params_from_mlm(clf, _port().state_dict())
    for k, v in grafted.items():
        src = (from_flax_params(_tiny_params())[k]
               if k.startswith(("embeddings.", "encoder.")) else own[k])
        assert torch.equal(v, src), k
    clf.load_state_dict(from_flax_params(jparams))
    got = clf(torch.as_tensor(ids)).detach().numpy()
    assert got.shape == (3, 3)
    assert _rel(got, want) <= 1e-5
    with pytest.raises(ValueError, match="encoder"):
        bert.classifier_params_from_mlm(clf, {"embeddings.x": 0})


class _OnMeta(TorchFunctionMode):
    """Every tensor a factory makes lands on the meta device whatever
    device it names: a full-width model's shapes without its storage."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if kwargs.get("device") is not None:
            kwargs = {**kwargs, "device": "meta"}
        return func(*args, **kwargs)


def test_bert_base_parameter_count():
    # the JAX test's analytic count (tests/test_bert.py)
    V, H, P, T, L, F = 30522, 768, 512, 2, 12, 3072
    emb = V * H + P * H + T * H + 2 * H
    per_layer = (3 * (H * H + H) + H * H + H + 2 * (2 * H) + H * F + F
                 + F * H + H)
    head = H * H + H + 2 * H + V
    with _OnMeta():
        model = bert.BertBase(device="cpu")
    assert all(p.is_meta for p in model.parameters())
    assert sum(p.numel() for p in model.parameters()) == (
        emb + L * per_layer + head) == 109_514_298


def test_unported_fields_raise():
    # a field of the JAX decoder that the JAX Bert does not have
    with pytest.raises(TypeError, match="use_bias"):
        bert.bert_tiny_test(device="cpu", use_bias=False)
    with pytest.raises(NotImplementedError, match="fused_qkv"):
        bert.bert_tiny_test(device="cpu", fused_qkv=True)


# ------------------------------------------------------- the train step --

def _batches():
    tokens = jdatasets.synthetic_tokens(64, SEQ, vocab=96)
    rng = np.random.default_rng(0)
    cfg = jmlm.MlmConfig(vocab_size=96, mask_id=96)
    return [jmlm.mask_tokens(tokens[rng.integers(0, 64, BATCH)], cfg, rng)
            for _ in range(STEPS)]


def _state_dict(params):
    return {k: v.numpy() for k, v in
            from_flax_params(jax.tree.map(np.asarray, params)).items()}


@functools.cache
def _jax_run(n):
    """(initial state_dict, per-step metrics, final state_dict) of the JAX
    `make_custom_train_step` with the example's loss over `n` CPU devices,
    on the whole batch (the port's `grad_accum` 2 runs are held to it: the
    weighted accumulation is the full-batch step)."""
    strat = MultiWorkerMirroredStrategy(
        mesh=make_mesh({"data": n}, devices=jax.devices()[:n]))
    tx = joptim.adamw(optax.warmup_cosine_decay_schedule(0.0, *SCHEDULE),
                      weight_decay=0.01)
    state, _ = j_init_state(jbert.Bert(**TINY, dtype=jnp.float32), tx, strat,
                            np.zeros((BATCH, SEQ), np.int32))
    initial = _state_dict(state.params)
    step = j_make_step(strat, state, jbert_mlm.mlm_loss_fn)
    history = []
    for batch in _batches():
        state, m = step(state, batch, jax.random.key(1))
        history.append({k: float(v) for k, v in m.items()})
    return initial, history, _state_dict(state.params)


#: the key biases: their gradient is zero in exact arithmetic (a shift
#: shared by a row's logits leaves its softmax unchanged) and rounding
#: noise in any precision, which Adam's normalised update turns into a
#: step of up to ~lr whose sign is the noise's (in fp64 too): they are held
#: to that bound (KEY_BIAS_BOUND), not to another run
KEY_BIAS = "attn.key.bias"
#: |key bias| after the steps: 3.2 (Adam's largest normalised step, (1 -
#: b1) / sqrt(1 - b2)) times the sum of the steps' lrs (0, 1e-3, 5e-4)
KEY_BIAS_BOUND = 3.2 * 1.5e-3


def _max_abs(got, want):
    """(max abs difference, where) over every tensor but the key biases,
    which must lie within KEY_BIAS_BOUND on both sides."""
    for k in want:
        if k.endswith(KEY_BIAS):
            assert np.max(np.abs(got[k])) <= KEY_BIAS_BOUND, k
            assert np.max(np.abs(want[k])) <= KEY_BIAS_BOUND, k
    errs = {k: float(np.max(np.abs(np.float64(got[k]) - want[k])))
            for k in want if not k.endswith(KEY_BIAS)}
    k = max(errs, key=errs.get)
    return errs[k], k


def _assert_matches_jax(got, n, grad_accum):
    _, history, want = _jax_run(n)
    err, where = _max_abs(got["state_dict"], want)
    print(f"{n} devices, grad_accum {grad_accum}: port vs JAX {err:.3e} "
          f"({where})")
    assert err <= STEP_ATOL, where
    for g, w in zip(got["history"], history, strict=True):
        assert set(g) == set(w) == {"loss", "mlm_accuracy", "grad_norm"}
        for k in w:
            assert abs(g[k] - w[k]) <= METRIC_ATOL * max(1.0, abs(w[k])), k


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_custom_steps_match_jax_on_one_device(grad_accum):
    initial, _, _ = _jax_run(1)
    got = testing.train_bert(initial, _batches(), SCHEDULE, grad_accum,
                             distributed=False)
    _assert_matches_jax(got, 1, grad_accum)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The port's runs at two gloo ranks under MultiWorkerMirroredStrategy,
    one spawn: {grad_accum: [rank 0's result, rank 1's]}."""
    initial, _, _ = _jax_run(2)
    jobs = [("train_bert", (initial, _batches(), SCHEDULE, accum), {})
            for accum in (1, 2)]
    store = str(tmp_path_factory.mktemp("bert") / "store")
    out = testing.run_ranks(testing.jobs_worker, [(2, store, jobs)] * 2,
                            timeout=300)
    return {accum: [out[0][i], out[1][i]] for i, accum in enumerate((1, 2))}


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_two_gloo_ranks_match_jax_over_two_devices(two_ranks, grad_accum):
    counts = [[int((labels[r * 8:(r + 1) * 8] != jmlm.IGNORE_ID).sum())
               for r in (0, 1)] for _, labels in _batches()]
    assert all(a != b for a, b in counts), counts  # the normalisation trap
    r0, r1 = two_ranks[grad_accum]
    _assert_matches_jax(r0, 2, grad_accum)
    assert r0["history"] == r1["history"]
    for k, v in r0["state_dict"].items():
        assert np.array_equal(v, r1["state_dict"][k]), k


def test_grad_accum_two_equals_the_full_batch(two_ranks):
    one, two = two_ranks[1][0], two_ranks[2][0]
    err, where = _max_abs(two["state_dict"], one["state_dict"])
    assert err <= STEP_ATOL, where


# ------------------------------------------------------------ entry point --

def test_entry_point_trains_and_resumes_on_the_cpu(tmp_path):
    argv = ["--tiny", "--device", "cpu", "--seq-len", "32", "--batch-size",
            "16", "--model-dir", str(tmp_path)]
    state, metrics = bert_mlm.main(argv + ["--max-steps", "2"])
    assert state.step == 2 and np.isfinite(float(metrics["loss"]))
    assert set(metrics) == {"loss", "mlm_accuracy", "grad_norm"}
    state, metrics = bert_mlm.main(argv + ["--max-steps", "3", "--remat"])
    assert state.step == 3
    with pytest.raises(RuntimeError, match="CUDA"):
        bert_mlm.main(["--tiny", "--max-steps", "1"])
    with pytest.raises(SystemExit):
        bert_mlm.main(["--tiny", "--device", "cpu", "--fake-devices", "8"])
