"""Routed experts through the port's models, training and serving paths,
held against the JAX package on shared weights (fp32, the CPU).

- An MoE `GPT` (`gpt_tiny_test` with 4 experts, `moe_every` 2 and 1):
  logits within 1e-5 relative Frobenius of `GPT.apply`, and greedy
  `generate` equal to JAX `generate` (the twin of
  `tests/test_decode.py::test_moe_gpt_decodes`).
- `next_token_loss` with the z-loss on: the loss, ``moe_aux`` and
  ``moe_z`` within 1e-5 of the JAX `next_token_loss`'s, every gradient
  within 1e-4 relative (the router and the experts included), then one
  AdamW step of the port's optimizer against optax's on the same
  weights (parameters within 1e-4).
- An MoE `Encoder` classifier (`testing.MoEClassifier`, the JAX MoE
  tests' `Clf`) through `make_train_step`: three sgd steps against the
  JAX step (the load-balance loss in the objective).
- `gpt_lm --tiny --device cpu --moe 4`: three steps, each loss within
  1e-5 of the JAX example's with the same flags and initial parameters.
- `ExpertParallelStrategy` at an expert axis of 1 over two gloo ranks:
  the bits of `MultiWorkerMirroredStrategy`'s run; above 1 it raises.
- The batcher: a dropless MoE (capacity E / k) in the dense, paged,
  prefix-cached and int8-KV layouts, each request's tokens equal to its
  solo `generate` in the same layout; a droppy one (capacity 1.25, where
  a wave's padding changes what drops) equal to the JAX batcher's tokens.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tfde_tpu.inference import server as jserver
from tfde_tpu.inference.decode import generate as j_generate
from tfde_tpu.models.gpt import gpt_tiny_test as j_tiny
from tfde_tpu.models.gpt import next_token_loss as j_next_token_loss
from tfde_tpu.models.transformer import Encoder as JEncoder
from tfde_tpu.parallel.strategies import MultiWorkerMirroredStrategy
from tfde_tpu.training import optimizers as joptim
from tfde_tpu.training.step import init_state as j_init_state
from tfde_tpu.training.step import make_train_step as j_train_step
from tfde_tpu_torch import gpt_lm, testing
from tfde_tpu_torch.inference import server as tserver
from tfde_tpu_torch.inference.decode import generate
from tfde_tpu_torch.models.flax_weights import from_flax_params
from tfde_tpu_torch.models.gpt import GPT, gpt_tiny_test, next_token_loss
from tfde_tpu_torch.models.moe import MoEMlp
from tfde_tpu_torch.models.transformer import init_flax_
from tfde_tpu_torch.training import optimizers as optim
from tfde_tpu_torch.training.step import init_state
from tfde_tpu_torch.testing import one_thread

#: one intra-op torch thread for the module (`testing.one_thread`)
_one_thread = pytest.fixture(autouse=True, scope="module")(one_thread)

#: the MoE fields of the tiny GPT for each `moe_every` (the z-loss on at
#: moe_every 1)
MOE = {2: dict(num_experts=4, moe_every=2),
       1: dict(num_experts=4, moe_every=1, router_z_loss_weight=1e-3)}


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _flat(named: dict) -> np.ndarray:
    return np.concatenate([np.asarray(named[n]).ravel()
                           for n in sorted(named)])


@pytest.fixture(scope="module")
def pairs():
    """{moe_every: (JAX model, flax params, port model)}; seeded weights
    in the flax layout (`testing.seeded_params`: no compiled `init`)."""
    out = {}
    for every, fields in MOE.items():
        jm = j_tiny(**fields)
        params = testing.seeded_params(jax.eval_shape(
            jm.init, jax.random.key(0), jnp.zeros((1, 8), jnp.int32)
        )["params"], every, std=0.2)
        tm = gpt_tiny_test(device="cpu", **fields)
        tm.load_state_dict(from_flax_params(params))
        out[every] = (jm, params, tm)
    return out


@pytest.mark.parametrize("every", [2, 1])
def test_moe_gpt_logits_match_jax(pairs, every):
    jm, params, tm = pairs[every]
    moe_blocks = [i for i, b in enumerate(tm.decoder.blocks())
                  if isinstance(b.moe, MoEMlp)]
    assert moe_blocks == ([1] if every == 2 else [0, 1])
    assert sorted(params["decoder"][f"block_{moe_blocks[0]}"]["moe"]) == [
        "experts_b1", "experts_b2", "experts_fc1", "experts_fc2", "router"]
    ids = np.random.default_rng(0).integers(0, 97, (3, 20))
    want = jax.jit(jm.apply)({"params": params}, jnp.asarray(ids))
    with torch.no_grad():
        got = tm(torch.as_tensor(ids))
    assert _rel(got.numpy(), want) <= 1e-5


@pytest.mark.parametrize("every", [2, 1])
def test_moe_gpt_generate_matches_jax(pairs, every):
    jm, params, tm = pairs[every]
    prompt = np.random.default_rng(1).integers(0, 97, (2, 4))
    want, want_len = j_generate(jm, params, jnp.asarray(prompt, jnp.int32),
                                max_new_tokens=5)
    got, got_len = generate(tm, torch.as_tensor(prompt), 5, device="cpu")
    assert got.shape == (2, 9)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))


@pytest.mark.parametrize("every", [2, 1])
def test_next_token_loss_metrics_gradients_and_a_step(pairs, every):
    jm, params, tm = pairs[every]
    tokens = np.random.default_rng(2).integers(0, 97, (8, 16))
    jstate = types.SimpleNamespace(apply_fn=jm.apply)
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        lambda p: j_next_token_loss(jstate, p, (jnp.asarray(tokens),),
                                    jax.random.key(0)),
        has_aux=True))(jax.tree.map(jnp.asarray, params))
    model = gpt_tiny_test(device="cpu", **MOE[every])
    model.load_state_dict(tm.state_dict())
    loss, metrics = next_token_loss(model, (torch.as_tensor(tokens),))
    names = {"moe_aux"} | ({"moe_z"} if every == 1 else set())
    assert set(metrics) == {"next_token_accuracy"} | names
    assert set(jmetrics) == set(metrics)
    for key in names:
        assert abs(float(metrics[key].detach()) - float(jmetrics[key])) \
            <= 1e-5 * abs(float(jmetrics[key]))
        assert float(metrics[key].detach()) > 0
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-5 * float(jloss)
    loss.backward()
    want = from_flax_params(jax.tree.map(np.asarray, jgrads))
    total = np.sqrt(sum(float((w.double() ** 2).sum())
                        for w in want.values()))
    for n, p in model.named_parameters():
        w = want[n].numpy()
        if np.linalg.norm(w) < 1e-6 * total:  # zero in exact arithmetic
            assert float(p.grad.norm()) < 1e-6 * total, n
        else:
            assert _rel(p.grad.numpy(), w) <= 1e-4, n
    assert any(float(p.grad.abs().max()) > 0 for n, p in
               model.named_parameters() if "router" in n)

    # one AdamW step on these gradients: the port's optimizer against
    # optax's (the JAX package's masked adamw) on the JAX gradients
    tx = joptim.adamw(1e-3, weight_decay=0.1)
    jparams = jax.tree.map(jnp.asarray, params)
    updates, _ = jax.jit(tx.update)(jgrads, tx.init(jparams), jparams)
    want = {n: t.numpy() for n, t in from_flax_params(jax.tree.map(
        np.asarray, optax.apply_updates(jparams, updates))).items()}
    state = init_state(model, optim.adamw(model, 1e-3, weight_decay=0.1))
    state.apply_gradients()
    got = {n: p.detach().numpy() for n, p in model.named_parameters()}
    assert _rel(_flat(got), _flat(want)) <= 1e-4


def test_moe_encoder_trains_under_make_train_step():
    """The JAX MoE tests' classifier: Dense -> a 2-block Encoder whose
    second block routes over 4 experts -> Dense, three sgd(0.1) steps of
    each package's `make_train_step`, the load-balance loss in both
    objectives."""
    import flax.linen as nn

    class Clf(nn.Module):
        @nn.compact
        def __call__(self, x, train=False):
            x = x.reshape(x.shape[0], 8, 8)
            x = nn.Dense(16, dtype=jnp.float32, name="embed")(x)
            x = JEncoder(depth=2, num_heads=2, head_dim=8, mlp_dim=32,
                         dtype=jnp.float32, num_experts=4, moe_every=2,
                         name="encoder")(x, train=train)
            return nn.Dense(10, dtype=jnp.float32, name="head")(
                jnp.mean(x, axis=1))

    strategy = MultiWorkerMirroredStrategy()
    jstate, _ = j_init_state(Clf(), optax.sgd(0.1), strategy,
                             np.zeros((16, 64), np.float32), seed=0)
    sd = {k: t.numpy() for k, t in from_flax_params(
        jax.tree.map(np.asarray, jstate.params)).items()}
    step = j_train_step(strategy, jstate, donate=False)
    rng = np.random.default_rng(0)
    batches = [(rng.random((16, 64), np.float32),
                rng.integers(0, 10, (16, 1)).astype(np.int32))
               for _ in range(3)]
    jlosses = []
    for batch in batches:
        jstate, metrics = step(jstate, batch, jax.random.key(0))
        jlosses.append(float(metrics["loss"]))
    run = testing.moe_encoder_train(sd, batches, 0.1)
    losses = [h["loss"] for h in run["history"]]
    assert np.allclose(losses, jlosses, rtol=1e-5, atol=0)
    want = {k: t.numpy() for k, t in from_flax_params(
        jax.tree.map(np.asarray, jstate.params)).items()}
    assert _rel(_flat(run["state_dict"]), _flat(want)) <= 1e-5
    assert losses[-1] < losses[0]
    # the aux loss is in the objective: without it the loss is lower
    model = testing.MoEClassifier()
    model.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()})
    sown = {}
    with torch.no_grad():
        model(torch.as_tensor(batches[0][0]), train=True, losses=sown)
        ce = torch.nn.functional.cross_entropy(
            model(torch.as_tensor(batches[0][0])),
            torch.as_tensor(batches[0][1][:, 0]).long())
    assert len(sown["moe_aux"]) == 1
    assert float(sown["moe_aux"][0]) == pytest.approx(
        jlosses[0] - float(ce), rel=1e-3)


def test_gpt_lm_moe_follows_the_jax_example(monkeypatch):
    """`gpt_lm --tiny --moe 4` against `examples/gpt_lm.py` with the same
    flags (the JAX example shards the experts over 4 of its 8 CPU
    devices, the port keeps them on one): the port's model takes the JAX
    run's initial parameters, and each step's loss (the load-balance loss
    in it) is held to the JAX one within 1e-5 relative."""
    from examples import gpt_lm as j_gpt_lm

    flags = ["--tiny", "--moe", "4", "--seq-len", "16", "--batch-size",
             "8", "--max-steps", "3", "--warmup-steps", "1",
             "--train-examples", "64"]
    want, got, initial = [], [], []

    def recording(make_step, losses):
        def make(*args, **kwargs):
            step = make_step(*args, **kwargs)

            def run(state, batch, rng=None):
                state, metrics = step(state, batch, rng)
                losses.append(float(metrics["loss"]))
                return state, metrics

            return run

        return make

    real_init = j_gpt_lm.init_state

    def init_state(*args, **kwargs):
        state, spec = real_init(*args, **kwargs)
        initial.append(jax.tree.map(np.asarray, state.params))
        return state, spec

    monkeypatch.setattr(j_gpt_lm, "init_state", init_state)
    monkeypatch.setattr(j_gpt_lm, "make_custom_train_step", recording(
        j_gpt_lm.make_custom_train_step, want))
    j_gpt_lm.main(flags)
    real_model = gpt_lm.gpt_tiny_test

    def model(**kw):
        m = real_model(**kw)
        m.load_state_dict(from_flax_params(initial[0]))
        return m

    monkeypatch.setattr(gpt_lm, "gpt_tiny_test", model)
    monkeypatch.setattr(gpt_lm, "make_custom_train_step", recording(
        gpt_lm.make_custom_train_step, got))
    state, metrics = gpt_lm.main(flags + ["--device", "cpu"])
    blocks = state.model.decoder.blocks()
    assert [b.moe is not None for b in blocks] == [False, True]
    assert blocks[1].moe.num_experts == 4
    assert blocks[1].moe.capacity_factor == 1.25
    assert state.step == 3 and len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert abs(g - w) <= 1e-5 * abs(w), (got, want)
    assert set(metrics) >= {"loss", "moe_aux", "next_token_accuracy"}
    assert 0 < float(metrics["moe_aux"]) < 1


def test_expert_parallel_at_axis_one_over_two_gloo_ranks(tmp_path):
    rng = np.random.default_rng(3)
    model = testing.MoEClassifier()
    init_flax_(model, torch.Generator().manual_seed(0))
    sd = {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}
    batches = [(rng.random((16, 64), np.float32),
                rng.integers(0, 10, (16, 1)).astype(np.int64))
               for _ in range(3)]
    jobs = [("moe_encoder_train", (sd, batches, 0.1),
             {"strategy": "ExpertParallelStrategy", "data": 2}),
            ("moe_encoder_train", (sd, batches, 0.1), {}),
            ("expert_axis_refusal", (), {})]
    out = testing.run_ranks(testing.jobs_worker,
                            [(2, str(tmp_path / "store"), jobs)] * 2,
                            timeout=300)
    one = testing.moe_encoder_train(sd, batches, 0.1)
    for rank in (0, 1):
        ep, mirrored, refusal = out[rank]
        assert ep["history"] == mirrored["history"]
        for k, v in ep["state_dict"].items():
            assert np.array_equal(v, mirrored["state_dict"][k]), k
            assert np.array_equal(v, out[0][0]["state_dict"][k]), k
        assert "expert axis of 2" in refusal
        assert "queue 1 item 6" in refusal
    # two ranks of 8 rows each: the one-process run's global batch
    losses = [h["loss"] for h in ep["history"]]
    assert np.allclose(losses, [h["loss"] for h in one["history"]],
                       rtol=1e-5)
    assert _rel(_flat(ep["state_dict"]), _flat(one["state_dict"])) <= 1e-5


# ------------------------------------------------------------ serving --

#: prompts of the batcher tests: two waves through three rows, a shared
#: 19-token prompt (a complete trie block repeats), a row reused
#: mid-flight
PROMPTS = [np.arange(3, 10) % 97, np.arange(5, 11) % 97,
           np.arange(40, 59) % 97, np.arange(7, 12) % 97,
           np.arange(40, 59) % 97, np.arange(60, 70) % 97]
BUDGETS = [8, 5, 12, 6, 9, 7]
KW = dict(batch_size=3, max_len=48, scan_depth=4)


def _drain(srv):
    ids = [srv.submit(p, n) for p, n in zip(PROMPTS, BUDGETS)]
    out = {}
    for _ in range(100):
        for rid, toks in srv.step():
            out[rid] = list(map(int, toks))
        if len(out) == len(ids):
            break
    assert len(out) == len(ids), "batcher did not drain"
    return [out[i] for i in ids]


def _dropless(kv_quant=None) -> GPT:
    """The tiny GPT with 4 experts in every block at the dropless
    capacity E / k = 2, random weights from seed 5."""
    return gpt_tiny_test(device="cpu", num_experts=4, moe_every=1,
                         moe_capacity_factor=2.0, kv_quant=kv_quant, seed=5)


@pytest.mark.parametrize("layout", ["dense", "paged", "prefix", "int8"])
def test_dropless_moe_batcher_equals_solo_generate(layout):
    model = _dropless("int8" if layout == "int8" else None)
    opts = {"paged": dict(paged=True, prefix_cache=True),
            "prefix": dict(prefix_cache=True)}.get(layout, {})
    srv = tserver.ContinuousBatcher(model, device="cpu", **opts, **KW)
    got = _drain(srv)
    if layout in ("paged", "prefix"):
        assert srv.prefix_cache.stats()["hits"] >= 1
    for p, n, toks in zip(PROMPTS, BUDGETS, got):
        solo, length = generate(model, torch.as_tensor(p[None]), n,
                                device="cpu")
        assert toks == solo[0, p.size:int(length[0])].tolist()


def test_droppy_moe_batcher_matches_the_jax_batcher(pairs):
    """Capacity 1.25 drops choices by each wave's composition (its padding
    included), in JAX as in the port: the batchers' tokens are equal."""
    jm, params, tm = pairs[2]
    jsrv = jserver.ContinuousBatcher(jm, params, kv_quant="fp", **KW)
    tsrv = tserver.ContinuousBatcher(tm, device="cpu", **KW)
    assert _drain(tsrv) == _drain(jsrv)
