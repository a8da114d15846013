"""The port's training slice (tfde_tpu_torch: ops/losses, models/gpt
next_token_loss, training/, data/, gpt_lm) held against the JAX package.

Losses against `tfde_tpu.ops.losses` (1e-6); the tiny GPT's next-token
loss and every parameter's gradient against `jax.value_and_grad` of the
JAX `next_token_loss` on shared weights (loss 1e-5, gradients 1e-4
relative Frobenius), with both attention implementations; the decay
mask, the schedule and AdamW against optax; five steps of the port's
`make_custom_train_step` against the JAX `init_state` +
`make_custom_train_step` on the 8-device CPU mesh (loss and grad_norm per
step and the final parameters within 1e-4); the synthetic corpus bit for
bit; and the entry point. fp32 on the CPU, inputs from numpy seeds.

A gradient that is zero in exact arithmetic — the key bias: adding q.b to
every logit of a row leaves its softmax unchanged — is rounding noise in
both frameworks (~1e-10 of the other gradients), so it is held to that
bound on both sides instead of relatively.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tfde_tpu.data import datasets as jdatasets
from tfde_tpu.models.gpt import gpt_tiny_test as j_tiny
from tfde_tpu.models.gpt import next_token_loss as j_next_token_loss
from tfde_tpu.ops import losses as jlosses
from tfde_tpu.parallel.strategies import MultiWorkerMirroredStrategy
from tfde_tpu.training import optimizers as joptim
from tfde_tpu.training.step import init_state as j_init_state
from tfde_tpu.training.step import make_custom_train_step as j_make_step
from tfde_tpu_torch import gpt_lm
from tfde_tpu_torch.data import datasets
from tfde_tpu_torch.models.flax_weights import from_flax_params
from tfde_tpu_torch.models.gpt import gpt_tiny_test, next_token_loss
from tfde_tpu_torch.ops import losses
from tfde_tpu_torch.training import optimizers as optim
from tfde_tpu_torch.training.step import init_state, make_custom_train_step
from tfde_tpu_torch.testing import one_thread

#: one intra-op torch thread for the module (`testing.one_thread`)
_one_thread = pytest.fixture(autouse=True, scope="module")(one_thread)


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _grads_close(got: dict, want: dict, tol: float) -> None:
    total = np.sqrt(sum(float(np.sum(np.square(w, dtype=np.float64)))
                        for w in want.values()))
    assert set(got) == set(want)
    for name, w in want.items():
        g = np.asarray(got[name])
        if np.linalg.norm(w) < 1e-6 * total:  # zero in exact arithmetic
            assert np.linalg.norm(g) < 1e-6 * total, name
        else:
            assert _rel(g, w) <= tol, name


def _flat(params: dict) -> np.ndarray:
    return np.concatenate([np.asarray(params[n]).ravel()
                           for n in sorted(params)])


# ------------------------------------------------------------- losses --

@pytest.mark.parametrize("ignored", [False, True])
def test_masked_lm_loss_matches_jax(ignored):
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 7, 11)).astype(np.float32) * 3
    labels = rng.integers(0, 11, (3, 7))
    labels[:, 0] = np.argmax(logits[:, 0], -1)  # some right answers
    if ignored:
        labels[rng.random((3, 7)) < 0.4] = -100
    want = jlosses.masked_lm_loss(jnp.asarray(logits), jnp.asarray(labels))
    got = losses.masked_lm_loss(torch.as_tensor(logits),
                                torch.as_tensor(labels))
    for g, w in zip(got, want):
        assert abs(float(g) - float(w)) <= 1e-6 * max(abs(float(w)), 1.0)


def test_masked_lm_loss_with_no_target_is_zero():
    logits = torch.zeros((2, 3, 5))
    loss, acc = losses.masked_lm_loss(logits, torch.full((2, 3), -100))
    assert float(loss) == 0.0 and float(acc) == 0.0


@pytest.mark.parametrize("from_logits,batch", [(True, None), (True, 16),
                                               (False, None)])
def test_sparse_categorical_crossentropy_matches_jax(from_logits, batch):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((8, 10)).astype(np.float32)
    if not from_logits:
        x = np.exp(x) / np.exp(x).sum(-1, keepdims=True)
    labels = rng.integers(0, 10, (8, 1))  # the reference's [N, 1] column
    want = jlosses.sparse_categorical_crossentropy(
        jnp.asarray(x), jnp.asarray(labels), from_logits, batch)
    got = losses.sparse_categorical_crossentropy(
        torch.as_tensor(x), torch.as_tensor(labels), from_logits, batch)
    assert abs(float(got) - float(want)) <= 1e-6 * abs(float(want))


# -------------------------------------------------------- model + grads --

@pytest.fixture(scope="module")
def tiny_params():
    params = jax.jit(j_tiny().init)(jax.random.key(1),
                                    jnp.zeros((1, 8), jnp.int32))["params"]
    return jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("impl", ["reference", "flash"])
def test_next_token_loss_and_gradients_match_jax(tiny_params, impl):
    jm = j_tiny(attn_impl=impl)
    tokens = np.random.default_rng(2).integers(0, 97, (3, 20))
    jstate = types.SimpleNamespace(apply_fn=jm.apply)
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        lambda p: j_next_token_loss(jstate, p, (jnp.asarray(tokens),),
                                    jax.random.key(0)),
        has_aux=True))(jax.tree.map(jnp.asarray, tiny_params))
    tm = gpt_tiny_test(device="cpu", attn_impl=impl)
    tm.load_state_dict(from_flax_params(tiny_params))
    loss, metrics = next_token_loss(tm, (torch.as_tensor(tokens),))
    loss.backward()
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-5 * float(jloss)
    assert float(metrics["next_token_accuracy"]) == pytest.approx(
        float(jmetrics["next_token_accuracy"]), abs=1e-6)
    # the converter is linear (reshapes and transposes), so it carries the
    # JAX gradients onto the port's parameter names
    want = {n: t.numpy() for n, t in from_flax_params(
        jax.tree.map(np.asarray, jgrads)).items()}
    _grads_close({n: p.grad.numpy() for n, p in tm.named_parameters()},
                 want, 1e-4)


# ------------------------------------------------------------ optimizer --

def test_decay_mask_matches_jax(tiny_params):
    jmask = joptim.decay_mask(tiny_params)
    # carry each flag through the converter as an array of the leaf's shape
    flags = jax.tree.map(lambda m, p: np.full(p.shape, float(m), np.float32),
                         jmask, tiny_params)
    want = {n: bool(t.flatten()[0]) for n, t in
            from_flax_params(flags).items()}
    got = optim.decay_mask(gpt_tiny_test(device="cpu"))
    assert got == want
    assert any(got.values()) and not all(got.values())


@pytest.mark.parametrize("init,peak,warmup,decay,end", [
    (0.0, 1e-3, 2, 5, 0.0), (1e-4, 3e-4, 100, 1000, 1e-5),
    (0.0, 1.0, 0, 10, 0.0), (0.0, 3e-4, 5, 20, 0.0)])
def test_schedule_matches_optax(init, peak, warmup, decay, end):
    want = optax.warmup_cosine_decay_schedule(init, peak, warmup, decay,
                                              end)
    got = optim.warmup_cosine_decay_schedule(init, peak, warmup, decay, end)
    # optax computes in float32: near the end of the cosine, 1 + cos
    # cancels and its value is good to ~1e-7 of the peak, not relatively
    for step in list(range(decay + 3)) + [2 * decay]:
        assert got(step) == pytest.approx(float(want(step)), rel=1e-6,
                                          abs=1e-7 * peak)


def test_schedule_refuses_an_empty_cosine():
    with pytest.raises(ValueError, match="decay_steps"):
        optim.warmup_cosine_decay_schedule(0.0, 1.0, 5, 5)


def _adamw_float64(params, grads, mask, lrs, b1=0.9, b2=0.999, eps=1e-8,
                   wd=0.1):
    """optax.adamw's arithmetic in float64: bias-corrected moments, eps
    outside the square root, decoupled decay on the masked parameters."""
    p = {n: v.astype(np.float64) for n, v in params.items()}
    m = {n: np.zeros_like(v) for n, v in p.items()}
    v2 = {n: np.zeros_like(v) for n, v in p.items()}
    for t, (g, lr) in enumerate(zip(grads, lrs), start=1):
        for n in p:
            m[n] = b1 * m[n] + (1 - b1) * g[n]
            v2[n] = b2 * v2[n] + (1 - b2) * g[n] ** 2
            upd = (m[n] / (1 - b1 ** t)) / (np.sqrt(v2[n] / (1 - b2 ** t))
                                            + eps)
            p[n] = p[n] - lr * (upd + (wd * p[n] if mask[n] else 0.0))
    return p


def test_adamw_updates_match_optax(tiny_params):
    """Two masked AdamW updates from fixed params and fixed gradients: the
    first at lr 0 (the warmup's first step moves nothing), the second at
    the peak. The port is held to optax's arithmetic carried out in
    float64 (1e-6), and to optax itself at 2e-5: optax computes the bias
    correction 1 - 0.999^t in float32, which at t = 2 (0.001999) is off
    by 2e-5 relative, and its update by half that."""
    sched = optax.warmup_cosine_decay_schedule(0.0, 1e-3, 1, 5)
    tx = joptim.adamw(sched, weight_decay=0.1)
    rng = np.random.default_rng(3)
    grads = [jax.tree.map(
        lambda p: rng.standard_normal(p.shape).astype(np.float32),
        tiny_params) for _ in range(2)]
    params = jax.tree.map(jnp.asarray, tiny_params)
    opt_state = tx.init(params)
    update = jax.jit(tx.update)
    tm = gpt_tiny_test(device="cpu")
    tm.load_state_dict(from_flax_params(tiny_params))
    state = init_state(tm, optim.adamw(
        tm, optim.warmup_cosine_decay_schedule(0.0, 1e-3, 1, 5),
        weight_decay=0.1))
    named = dict(tm.named_parameters())
    for g in grads:
        updates, opt_state = update(jax.tree.map(jnp.asarray, g),
                                    opt_state, params)
        params = optax.apply_updates(params, updates)
        for n, t in from_flax_params(g).items():
            named[n].grad = t
        state.apply_gradients()
        want = from_flax_params(jax.tree.map(np.asarray, params))
        for n, p in named.items():
            assert _rel(p.detach().numpy(), want[n].numpy()) <= 2e-5, n
    assert state.step == 2
    exact = _adamw_float64(
        {n: t.numpy() for n, t in from_flax_params(tiny_params).items()},
        [{n: t.numpy().astype(np.float64)
          for n, t in from_flax_params(g).items()} for g in grads],
        optim.decay_mask(tm), [0.0, 1e-3])
    for n, p in named.items():
        assert _rel(p.detach().numpy(), exact[n]) <= 1e-6, n


# ------------------------------------------------------- the train step --

@pytest.mark.parametrize("grad_accum,impl", [
    (1, "reference"), (2, "reference"), (2, "flash")])
def test_five_steps_match_the_jax_train_step(grad_accum, impl):
    batch, seq, steps = 16, 16, 5
    strategy = MultiWorkerMirroredStrategy()
    jm = j_tiny(attn_impl=impl)
    jstate, _ = j_init_state(
        jm, joptim.adamw(optax.warmup_cosine_decay_schedule(0.0, 1e-3, 2,
                                                            steps),
                         weight_decay=0.1),
        strategy, np.zeros((batch, seq), np.int32))
    tm = gpt_tiny_test(device="cpu", attn_impl=impl)
    tm.load_state_dict(from_flax_params(jax.tree.map(np.asarray,
                                                     jstate.params)))
    tstate = init_state(tm, optim.adamw(
        tm, optim.warmup_cosine_decay_schedule(0.0, 1e-3, 2, steps),
        weight_decay=0.1))
    jstep = j_make_step(strategy, jstate, j_next_token_loss,
                        grad_accum=grad_accum)
    tstep = make_custom_train_step(next_token_loss, grad_accum=grad_accum)
    tokens = datasets.synthetic_tokens(64, seq, vocab=97)
    rng = np.random.default_rng(0)
    for _ in range(steps):
        x = tokens[rng.integers(0, len(tokens), batch)]
        jstate, jmetrics = jstep(jstate, (x,), jax.random.key(1))
        tstate, tmetrics = tstep(tstate, (torch.as_tensor(x),))
        for key in ("loss", "grad_norm", "next_token_accuracy"):
            w = float(jmetrics[key])
            assert abs(float(tmetrics[key]) - w) <= 1e-4 * max(abs(w), 1e-3)
    assert tstate.step == steps
    want = from_flax_params(jax.tree.map(np.asarray, jstate.params))
    got = {n: p.detach().numpy() for n, p in tm.named_parameters()}
    assert _rel(_flat(got), _flat({n: t.numpy() for n, t in want.items()})) \
        <= 1e-4


def test_grad_weight_accumulation_and_a_weightless_batch():
    """A loss returning ``grad_weight`` has each microbatch weighted by
    it, giving the full-batch gradient of a count-normalised loss; a
    batch whose every weight is zero makes a clean zero update."""
    torch.manual_seed(0)
    x = torch.randn(8, 3)
    w = torch.tensor([1.0, 1, 1, 0, 1, 0, 0, 0])

    def loss_fn(model, batch, _gen):
        xb, wb = batch
        per = (model(xb)[:, 0] - 1.0) ** 2
        n = wb.sum()
        return (per * wb).sum() / n.clamp_min(1.0), {"grad_weight": n}

    def run(accum, weights):
        model = torch.nn.Linear(3, 1)
        with torch.no_grad():
            model.weight.fill_(0.5)
            model.bias.zero_()
        state = init_state(model, optim.adamw(model, 0.1, weight_decay=0.0))
        _, metrics = make_custom_train_step(loss_fn, accum)(state,
                                                            (x, weights))
        return model, metrics

    full, m_full = run(1, w)
    split, m_split = run(2, w)
    assert float(m_split["loss"]) == pytest.approx(float(m_full["loss"]),
                                                   rel=1e-6)
    assert float(m_split["grad_norm"]) == pytest.approx(
        float(m_full["grad_norm"]), rel=1e-6)
    torch.testing.assert_close(split.weight, full.weight)
    none, m_none = run(2, torch.zeros(8))
    assert float(m_none["grad_norm"]) == 0.0
    assert torch.equal(none.weight, torch.full((1, 3), 0.5))


def test_train_step_refuses_a_batch_it_cannot_split():
    model = gpt_tiny_test(device="cpu")
    state = init_state(model, optim.adamw(model, 1e-3))
    step = make_custom_train_step(next_token_loss, grad_accum=3)
    with pytest.raises(ValueError, match="grad_accum"):
        step(state, (torch.zeros((4, 8), dtype=torch.long),))
    with pytest.raises(ValueError, match="grad_accum"):
        make_custom_train_step(next_token_loss, grad_accum=0)


# ------------------------------------------------------- data, entry point --

@pytest.mark.parametrize("n,seq,vocab,seed", [(16, 32, 97, 2),
                                              (8, 64, 50257, 5)])
def test_synthetic_tokens_are_the_jax_packages(n, seq, vocab, seed):
    got = datasets.synthetic_tokens(n, seq, vocab=vocab, seed=seed)
    want = jdatasets.synthetic_tokens(n, seq, vocab=vocab, seed=seed)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_gpt_lm_trains_the_tiny_model_on_the_cpu():
    state, metrics = gpt_lm.main([
        "--tiny", "--device", "cpu", "--max-steps", "3", "--batch-size",
        "4", "--seq-len", "16", "--train-examples", "64"])
    assert state.step == 3
    assert set(metrics) == {"loss", "next_token_accuracy", "grad_norm"}
    assert all(np.isfinite(float(v)) for v in metrics.values())


def test_gpt_lm_runs_on_cuda_unless_asked_for_the_cpu():
    with pytest.raises(RuntimeError, match="CUDA"):
        gpt_lm.main(["--tiny", "--max-steps", "1"])


@pytest.mark.parametrize("flag", [["--pipeline", "2"], ["--moe", "4"],
                                  ["--microbatches", "4"]])
def test_gpt_lm_refuses_unported_flags(flag, capsys):
    with pytest.raises(SystemExit) as exc:
        gpt_lm.main(["--tiny", "--device", "cpu", *flag])
    assert exc.value.code == 2
    assert "unrecognized arguments" in capsys.readouterr().err
