"""The rolling KV cache and `generate_ragged` of the port against the JAX
package (`tfde_tpu/inference/decode.py`, `models/transformer.py`
`_rolling_attention`; the twins of `tests/test_rolling_cache.py` and the
ragged cases of `tests/test_decode.py`).

On converted weights, fp32, the port's greedy tokens and lengths must EQUAL
the JAX ones exactly: `generate_ragged` on a plain and on a windowed model
(rolling), rolling `generate` with prompts shorter and longer than the
window, each against the port's own full-budget decode loop too. The
rolling planes hold min(budget, window) slots on windowed layers (the
global layers of an 'alternate' model keep the budget, as in JAX);
speculative decoding keeps the full cache; the refusals (int8 or paged
with rolling, per-row indices on a rolling cache) are JAX's.
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
from tfde_tpu_torch.models.transformer import Encoder, TransformerBlock
from tfde_tpu_torch.testing import one_thread

#: one intra-op torch thread for the module (`testing.one_thread`)
_one_thread = pytest.fixture(autouse=True, scope="module")(one_thread)

VOCAB = 97
#: the plain config and the windowed one (rope, GQA, window 8): depth 2,
#: width 64
PLAIN = dict(vocab_size=VOCAB, hidden_size=64, depth=2, num_heads=4,
             mlp_dim=128, max_position=128)
WINDOWED = dict(PLAIN, position="rope", num_kv_heads=2, sliding_window=8)


def _pair(fields, key):
    jm = JGPT(**fields, dtype=jnp.float32)
    params = jm.init(jax.random.key(key), jnp.zeros((1, 8), jnp.int32))[
        "params"]
    tm = GPT(**fields, dtype=torch.float32, device="cpu")
    tm.load_state_dict(from_flax_params(jax.tree.map(np.asarray, params)))
    return jm, params, tm


@pytest.fixture(scope="module")
def models():
    return {"plain": _pair(PLAIN, 1), "windowed": _pair(WINDOWED, 0)}


def _full_cache_greedy(tm, prompt, n):
    """The oracle: greedy decoding on the full-budget cache, one token a
    step from a shared int index."""
    cache = tdecode.init_cache(tm, prompt.shape[0], prompt.shape[1] + n)
    with torch.no_grad():
        logits = tm(torch.as_tensor(prompt), cache=cache)[:, -1]
        out = [logits.argmax(-1)]
        for _ in range(n - 1):
            out.append(tm(out[-1][:, None], cache=cache)[:, -1].argmax(-1))
    return torch.stack(out, dim=1).numpy()


def _ragged_batch(rng, lengths):
    rows = [rng.integers(0, VOCAB, n) for n in lengths]
    padded = np.zeros((len(rows), max(lengths)), np.int64)
    for i, r in enumerate(rows):
        padded[i, :r.size] = r
    return rows, padded


@pytest.mark.parametrize("kind,lengths,new", [
    ("plain", [3, 7, 5], 6), ("windowed", [3, 6], 20)])
def test_generate_ragged_matches_jax_and_solo(models, kind, lengths, new):
    """Greedy tokens and lengths equal JAX `generate_ragged`; each row
    equals the port's solo `generate` of the unpadded row (under the
    windowed model: on the rolling cache, past the window), pad after."""
    jm, params, tm = models[kind]
    rows, padded = _ragged_batch(np.random.default_rng(3), lengths)
    want, want_len = jdecode.generate_ragged(
        jm, params, jnp.asarray(padded, jnp.int32), lengths,
        max_new_tokens=new)
    got, got_len = tdecode.generate_ragged(tm, padded, lengths, new,
                                           device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    assert got_len.tolist() == [n + new for n in lengths]
    for i, r in enumerate(rows):
        solo, _ = tdecode.generate(tm, r[None], new, device="cpu")
        np.testing.assert_array_equal(got[i, :r.size + new].numpy(),
                                      solo[0].numpy())
        assert (got[i, r.size + new:] == 0).all()


def test_generate_ragged_eos_per_row(models):
    """EOS stops one row without touching the others, as in JAX."""
    jm, params, tm = models["plain"]
    lengths = [4, 6]
    _rows, padded = _ragged_batch(np.random.default_rng(4), lengths)
    free, _ = tdecode.generate_ragged(tm, padded, lengths, 5, device="cpu")
    eos = int(free[0, 4])  # row 0's first generated token
    got, got_len = tdecode.generate_ragged(tm, padded, lengths, 5,
                                           eos_id=eos, pad_id=0,
                                           device="cpu")
    want, want_len = jdecode.generate_ragged(
        jm, params, jnp.asarray(padded, jnp.int32), lengths,
        max_new_tokens=5, eos_id=eos, pad_id=0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    assert int(got_len[0]) == 5 and (got[0, 5:] == 0).all()


@pytest.mark.parametrize("lengths,kw,match", [
    ([3], {}, "prompt_lengths"),
    ([3, 9], {}, r"\[1, 6\]"),
    ([3, 5], {"prefill_len": 4}, "prefill_len"),
])
def test_generate_ragged_refusals(models, lengths, kw, match):
    """The same ValueErrors, with JAX's messages."""
    jm, params, tm = models["plain"]
    prompt = np.zeros((2, 6), np.int64)
    with pytest.raises(ValueError, match=match) as jerr:
        jdecode.generate_ragged(jm, params, jnp.asarray(prompt, jnp.int32),
                                lengths, max_new_tokens=2, **kw)
    with pytest.raises(ValueError, match=match) as terr:
        tdecode.generate_ragged(tm, prompt, lengths, 2, device="cpu", **kw)
    assert str(terr.value) == str(jerr.value)


def _jax_cache_lengths(jm, batch, budget, rolling):
    cache = jdecode.init_cache(jm, batch, budget, rolling=rolling)
    return [cache["decoder"][f"block_{i}"]["attn"]["cached_key"].shape[1]
            for i in range(jm.depth)]


@pytest.mark.parametrize("pattern", ["all", "alternate"])
def test_rolling_planes_are_window_bounded(pattern):
    """Each windowed layer's planes hold min(budget, window) slots, the
    global layers of an 'alternate' model the budget: JAX's cache shapes."""
    fields = dict(WINDOWED, sliding_window_pattern=pattern)
    jm = JGPT(**fields, dtype=jnp.float32)
    tm = GPT(**fields, dtype=torch.float32, device="cpu")
    for budget in (64, 5):
        cache = tdecode.init_cache(tm, 2, budget, rolling=True)
        assert cache.rolling
        got = [k.shape[1] for k in cache.keys]
        assert got == _jax_cache_lengths(jm, 2, budget, True)
        assert got == [min(budget, 8) if pattern == "all" or i % 2 == 0
                       else budget for i in range(tm.depth)]
        assert [tuple(v.shape) for v in cache.values] == [
            (2, n, 2, 16) for n in got]
    full = tdecode.init_cache(tm, 2, 64)
    assert not full.rolling and [k.shape[1] for k in full.keys] == [64, 64]
    # a model without a window: rolling=True is the full cache, as JAX's
    # _decode_clone engages rolling only under a window
    plain = GPT(**PLAIN, dtype=torch.float32, device="cpu")
    cache = tdecode.init_cache(plain, 2, 64, rolling=True)
    assert not cache.rolling and cache.keys[0].shape[1] == 64


@pytest.mark.parametrize("prompt_len,new", [(6, 34), (20, 12)])
def test_rolling_generate_matches_full_cache_and_jax(models, prompt_len,
                                                     new):
    """Greedy `generate` (rolling: a window model) far past the window, and
    with a prompt (20) longer than the window (8), whose prefill attends
    in the call and keeps the newest 8: equal to the port's full-cache
    loop and to JAX `generate` (rolling too)."""
    jm, params, tm = models["windowed"]
    prompt = np.random.default_rng(prompt_len).integers(
        0, VOCAB, (2, prompt_len))
    got, _ = tdecode.generate(tm, prompt, new, device="cpu")
    np.testing.assert_array_equal(got[:, prompt_len:].numpy(),
                                  _full_cache_greedy(tm, prompt, new))
    want, _ = jdecode.generate(jm, params, jnp.asarray(prompt, jnp.int32),
                               max_new_tokens=new)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_rolling_generate_alternate_pattern(models):
    """An 'alternate' window model (the Gemma-2 interleave): rolling local
    layers beside full global ones give the full-cache tokens."""
    fields = dict(WINDOWED, sliding_window_pattern="alternate")
    jm, params, tm = _pair(fields, 5)
    prompt = np.random.default_rng(5).integers(0, VOCAB, (2, 12))
    got, _ = tdecode.generate(tm, prompt, 20, device="cpu")
    np.testing.assert_array_equal(got[:, 12:].numpy(),
                                  _full_cache_greedy(tm, prompt, 20))
    want, _ = jdecode.generate(jm, params, jnp.asarray(prompt, jnp.int32),
                               max_new_tokens=20)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_speculative_decoding_keeps_rolling_off(models):
    """Speculative decoding rewinds, so it decodes on the full-budget cache
    (a rolling cache would refuse its per-row rewind at batch 2): greedy
    speculation equals greedy `generate` and JAX's speculation."""
    jm, params, tm = models["windowed"]
    jd, dparams, td = _pair(dict(WINDOWED, depth=1), 6)
    prompt = np.asarray([[5, 9, 2, 7], [1, 3, 3, 8]])
    ref, _ = tdecode.generate(tm, prompt, 16, device="cpu")
    got, _ = tspec.generate_speculative(tm, td, prompt, 16, num_draft=3,
                                        device="cpu")
    np.testing.assert_array_equal(got.numpy(), ref.numpy())
    want, _ = jspec.generate_speculative(
        jm, jd, params, dparams, jnp.asarray(prompt, jnp.int32),
        max_new_tokens=16, num_draft=3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_rolling_refusals(models):
    """int8 or paged with rolling raise ValueError with JAX's messages; a
    per-row index on a rolling cache raises NotImplementedError as JAX's
    layer does, and so does (ValueError) a call longer than the window
    anywhere but at position 0."""
    jm, params, tm = models["windowed"]
    for kw in ({"kv_quant": "int8"}, {"paged_blocks": 4}):
        with pytest.raises(ValueError, match="mutually exclusive") as jerr:
            jdecode.init_cache(jm, 1, 16, rolling=True, **kw)
        with pytest.raises(ValueError, match="mutually exclusive") as terr:
            tdecode.init_cache(tm, 1, 16, rolling=True, **kw)
        assert str(terr.value) == str(jerr.value)
    cache = tdecode.init_cache(tm, 2, 32, rolling=True)
    tok = torch.zeros((2, 1), dtype=torch.int64)
    with torch.no_grad():
        tm(torch.zeros((2, 4), dtype=torch.int64), cache=cache)
        cache.set_index(torch.tensor([4, 4]))
        with pytest.raises(NotImplementedError, match="per-row"):
            tm(tok, cache=cache)
        cache.set_index(4)
        with pytest.raises(ValueError, match="position 0"):
            tm(torch.zeros((2, 9), dtype=torch.int64), cache=cache)


def test_rolling_cache_field_is_accepted(models):
    """`rolling_cache` (JAX's decode-clone flag) builds on GPT, Encoder and
    TransformerBlock (no NotImplementedError) and is kept in GPT's config;
    the drivers pick the layout, so the model decodes as the one without
    the flag."""
    _jm, _params, tm = models["windowed"]
    flagged = GPT(**WINDOWED, rolling_cache=True, dtype=torch.float32,
                  device="cpu")
    flagged.load_state_dict(tm.state_dict())
    assert flagged.config["rolling_cache"] is True
    assert tm.config["rolling_cache"] is False
    prompt = np.random.default_rng(8).integers(0, VOCAB, (1, 5))
    a, _ = tdecode.generate(flagged, prompt, 12, device="cpu")
    b, _ = tdecode.generate(tm, prompt, 12, device="cpu")
    assert torch.equal(a, b)
    Encoder(1, 32, 4, 8, 64, torch.float32, rolling_cache=True,
            device="cpu")
    TransformerBlock(32, 4, 8, 64, torch.float32, rolling_cache=True,
                     device="cpu")
