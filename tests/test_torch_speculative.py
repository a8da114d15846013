"""Speculative decoding of the port (`tfde_tpu_torch/inference/
speculative.py`) against the JAX package's `generate_speculative` (the twin
of `tests/test_speculative.py`).

On converted weights, fp32 (JAX's docstring names a bf16 near-tie caveat
of the verify GEMM; fp32 holds tokens exactly): greedy tokens, lengths and
`return_stats` (rounds, generated, tokens a round) EQUAL JAX's for
num_draft 1, 2, 4 and 8 at batch 1 and 3, with a wrong draft (a smaller
model: almost nothing accepted) and a near one (the target's weights plus
noise: acceptance lengths diverge across rows every round, so the per-row
rewind is exercised); a perfect draft commits num_draft + 1 a round; EOS,
a rope + GQA target and a one-token prompt; the argument refusals.
Sampled mode: reproducible under one generator seed, EOS respected, and
the joint distribution of two sampled tokens over 8,000 rows is the
target's own (a chi-square bound), not the draft's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfde_tpu.inference import decode as jdecode
from tfde_tpu.inference import speculative as jspec
from tfde_tpu.models.gpt import GPT as JGPT
from tfde_tpu_torch.inference import decode as tdecode
from tfde_tpu_torch.inference import speculative as tspec
from tfde_tpu_torch.models.flax_weights import from_flax_params
from tfde_tpu_torch.models.gpt import GPT
from tfde_tpu_torch.testing import one_thread

#: one intra-op torch thread for the module (`testing.one_thread`)
_one_thread = pytest.fixture(autouse=True, scope="module")(one_thread)

VOCAB = 97
TARGET = dict(vocab_size=VOCAB, hidden_size=64, depth=2, num_heads=4,
              mlp_dim=128, max_position=64)
#: the wrong draft: smaller and initialised apart
SMALL = dict(vocab_size=VOCAB, hidden_size=16, depth=1, num_heads=2,
             mlp_dim=32, max_position=64)
#: the near draft's noise, relative to each parameter's spread
NEAR_NOISE = 0.35


def _pair(fields, key, noise_of=None):
    jm = JGPT(**fields, dtype=jnp.float32)
    if noise_of is None:
        params = jm.init(jax.random.key(key), jnp.zeros((1, 8), jnp.int32))[
            "params"]
    else:
        rng = np.random.default_rng(key)
        params = jax.tree.map(
            lambda a: a + NEAR_NOISE * (np.std(a) + 1e-3)
            * rng.standard_normal(a.shape).astype(np.float32), noise_of)
    tm = GPT(**fields, dtype=torch.float32, device="cpu")
    tm.load_state_dict(from_flax_params(jax.tree.map(np.asarray, params)))
    return jm, params, tm


@pytest.fixture(scope="module")
def models():
    target = _pair(TARGET, 1)
    return {"target": target, "wrong": _pair(SMALL, 9),
            "near": _pair(TARGET, 2, noise_of=target[1])}


def _both(models, draft, prompt, new, **kw):
    jm, params, tm = models["target"]
    jd, dparams, td = models[draft]
    want = jspec.generate_speculative(
        jm, jd, params, dparams, jnp.asarray(prompt, jnp.int32), new,
        return_stats=True, **kw)
    got = tspec.generate_speculative(tm, td, prompt, new, return_stats=True,
                                     device="cpu", **kw)
    return want, got


def _hold_equal(want, got):
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert {k: got[2][k] for k in want[2]} == want[2]


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("num_draft", [1, 2, 4, 8])
def test_greedy_matches_jax_and_generate(models, num_draft, batch):
    """The near draft: tokens, lengths and stats equal JAX's, the tokens
    equal greedy `generate`; acceptance lies strictly between 0 and 1."""
    prompt = np.random.default_rng(num_draft).integers(0, VOCAB, (batch, 5))
    want, got = _both(models, "near", prompt, 12, num_draft=num_draft)
    _hold_equal(want, got)
    ref, ref_len = tdecode.generate(models["target"][2], prompt, 12,
                                    device="cpu")
    assert torch.equal(got[0], ref) and torch.equal(got[1], ref_len)
    assert 0.0 < got[2]["acceptance_rate"] < 1.0


def test_wrong_draft_matches_jax(models):
    prompt = np.random.default_rng(11).integers(0, VOCAB, (3, 5))
    want, got = _both(models, "wrong", prompt, 12, num_draft=4)
    _hold_equal(want, got)


def test_perfect_draft_full_acceptance(models):
    """Draft == target: every proposal accepted, ceil(9 / 4) rounds for
    10 tokens at num_draft 3, and the text is greedy `generate`'s. The
    last round has room for one token, the target's own: it proposes
    nothing the budget could commit, so acceptance is 1.0."""
    _jm, _params, tm = models["target"]
    prompt = np.random.default_rng(12).integers(0, VOCAB, (2, 4))
    ref, _ = tdecode.generate(tm, prompt, 10, device="cpu")
    out, _, stats = tspec.generate_speculative(
        tm, tm, prompt, 10, num_draft=3, return_stats=True, device="cpu")
    assert torch.equal(out, ref)
    assert stats["rounds"] == 3 and stats["tokens_per_round"] == 3.0
    assert stats["acceptance_rate"] == 1.0


@pytest.mark.parametrize("batch", [1, 3])
def test_eos_matches_jax(models, batch):
    _jm, _params, tm = models["target"]
    prompt = np.random.default_rng(13).integers(0, VOCAB, (batch, 4))
    free, _ = tdecode.generate(tm, prompt, 10, device="cpu")
    eos = int(free[0, 6])  # row 0's third generated token
    want, got = _both(models, "near", prompt, 10, num_draft=4, eos_id=eos,
                      pad_id=0)
    _hold_equal(want, got)
    ref, ref_len = tdecode.generate(tm, prompt, 10, eos_id=eos, device="cpu")
    assert torch.equal(got[0], ref) and torch.equal(got[1], ref_len)
    assert int(got[1][0]) == 5 + free[0, 4:].tolist().index(eos)


def test_rope_gqa_target(models):
    """Index surgery with per-row rotations and a GQA cache."""
    fields = dict(TARGET, position="rope", num_kv_heads=2)
    target = _pair(fields, 3)
    pair = {"target": target, "near": _pair(fields, 4, noise_of=target[1])}
    prompt = np.random.default_rng(14).integers(0, VOCAB, (3, 6))
    want, got = _both(pair, "near", prompt, 9, num_draft=3)
    _hold_equal(want, got)
    ref, _ = tdecode.generate(target[2], prompt, 9, device="cpu")
    assert torch.equal(got[0], ref)


def test_learned_positions_at_the_table_end():
    """prompt + max_new_tokens == max_position: the last rounds feed
    proposals at positions past the table, whose embedding is NaN. The
    cache stores nan_to_num of the written K/V, so the masked cells add
    nothing and the tokens equal greedy `generate` (the port's and
    JAX's) at batch 1 and 2. (JAX's speculative decoding stores the NaN
    and emits token 0 at the budget's end there.)"""
    fields = dict(TARGET, max_position=16)
    jm, params, tm = _pair(fields, 1)
    prompt = np.asarray([[1, 2, 3, 4], [5, 6, 7, 8]])
    for b in (1, 2):
        ref, _ = tdecode.generate(tm, prompt[:b], 12, device="cpu")
        want, _ = jdecode.generate(jm, params,
                                   jnp.asarray(prompt[:b], jnp.int32), 12)
        np.testing.assert_array_equal(ref.numpy(), np.asarray(want))
        got, _ = tspec.generate_speculative(tm, tm, prompt[:b], 12,
                                            num_draft=4, device="cpu")
        assert torch.equal(got, ref)


def test_single_token_prompt(models):
    want, got = _both(models, "near", np.asarray([[7]]), 8, num_draft=2)
    _hold_equal(want, got)


@pytest.mark.parametrize("kw,match", [
    ({"max_new_tokens": 4, "num_draft": 0}, "num_draft"),
    ({"max_new_tokens": 0}, "max_new_tokens"),
    ({"max_new_tokens": 61}, "max_position"),
])
def test_refusals(models, kw, match):
    """The same ValueErrors, with JAX's messages."""
    jm, params, tm = models["target"]
    jd, dparams, td = models["wrong"]
    prompt = np.zeros((1, 4), np.int64)
    with pytest.raises(ValueError, match=match) as jerr:
        jspec.generate_speculative(jm, jd, params, dparams,
                                   jnp.asarray(prompt, jnp.int32), **kw)
    with pytest.raises(ValueError, match=match) as terr:
        tspec.generate_speculative(tm, td, prompt, device="cpu", **kw)
    assert str(terr.value) == str(jerr.value)


def _sampled(models, prompt, seed, **kw):
    _jm, _params, tm = models["target"]
    gen = torch.Generator().manual_seed(seed)
    return tspec.generate_speculative(tm, models["near"][2], prompt, 8,
                                      num_draft=3, temperature=0.7,
                                      generator=gen, device="cpu", **kw)


def test_sampled_reproducible_and_respects_eos(models):
    prompt = np.asarray([[5, 9], [2, 11], [40, 1], [8, 8]])
    a, la = _sampled(models, prompt, 11)
    b, lb = _sampled(models, prompt, 11)
    c, _ = _sampled(models, prompt, 12)
    assert torch.equal(a, b) and torch.equal(la, lb)
    assert not torch.equal(a, c)
    eos = int(a[0, 2])  # row 0's first generated token
    d, ld = _sampled(models, prompt, 11, eos_id=eos, pad_id=0)
    assert int(ld[0]) == 3 and (d[0, 3:] == 0).all()
    for r in range(4):
        row = d[r, 2:int(ld[r])].tolist()
        assert eos not in row[:-1]
        assert int(ld[r]) == 10 or row[-1] == eos


#: the distribution test: vocab 8, rows in one call, the chi-square bound
#: (63 degrees of freedom: the 0.999 quantile is 103.4)
DIST_VOCAB, DIST_ROWS, CHI2_BOUND = 8, 8000, 103.4


def test_sampled_joint_matches_the_target_distribution():
    """Speculative SAMPLING is exact (Leviathan et al.): over 8,000 rows of
    one call (the first token from the prefill, the second from a round
    of num_draft 2 with a different draft) the empirical joint of the two
    tokens matches the target's exact joint p(t1) p(t2 | t1) at
    temperature 1 — chi-square below the 0.999 quantile — while the
    joint with the draft's conditional in place of the target's is far
    outside it (the test's power). Fixed seed."""
    def small(seed, width):
        return GPT(vocab_size=DIST_VOCAB, hidden_size=width, depth=1,
                   num_heads=2, mlp_dim=2 * width, max_position=16,
                   dtype=torch.float32, device="cpu", seed=seed)

    target, draft = small(2, 16), small(8, 8)
    for m in (target, draft):  # sharper than 0.02-scale random logits
        m.wte.weight.data.mul_(4.0)
    prompt = np.tile(np.asarray([[3, 7]]), (DIST_ROWS, 1))
    out, _ = tspec.generate_speculative(
        target, draft, prompt, 2, num_draft=2, temperature=1.0,
        generator=torch.Generator().manual_seed(0), device="cpu")
    pairs = out[:, 2] * DIST_VOCAB + out[:, 3]
    counts = np.bincount(pairs.numpy(), minlength=DIST_VOCAB ** 2)

    def joint(second):
        with torch.no_grad():
            p1 = torch.softmax(target(torch.as_tensor([[3, 7]]))[0, -1], -1)
            ctx = torch.cat([torch.as_tensor([[3, 7]]).repeat(DIST_VOCAB, 1),
                             torch.arange(DIST_VOCAB)[:, None]], dim=1)
            p2 = torch.softmax(second(ctx)[:, -1], -1)
        return (p1[:, None] * p2).reshape(-1).double().numpy()

    def chi2(p):
        expected = DIST_ROWS * p
        return float(((counts - expected) ** 2 / expected).sum())

    exact = joint(target)
    assert exact.min() * DIST_ROWS > 5.0  # chi-square's validity
    assert chi2(exact) < CHI2_BOUND
    assert chi2(joint(draft)) > 10 * CHI2_BOUND
