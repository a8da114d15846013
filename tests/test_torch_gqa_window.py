"""The port's GPT with rotary positions, grouped-query attention and the
sliding window (tfde_tpu_torch/models/gpt.py, models/transformer.py) on
the JAX package's weights.

For each configuration `from_flax_params` carries the JAX
`gpt_tiny_test(**config)` params into the port; the port's full-sequence
logits, and its cached prefill followed by per-row decode ticks, are held
against `GPT.apply` and the JAX decode clone within 1e-5 relative
Frobenius, fp32 on the CPU, with both attention implementations (the
flash implementation's plain version takes GQA and the window, as the
kernels do). The sequences are longer than the window, so the band
masks something in the prefill and in every tick. The batcher serves
the combined configuration with the greedy tokens of `generate`.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfde_tpu.inference.decode import _decode_clone
from tfde_tpu.inference.decode import init_cache as j_init_cache
from tfde_tpu.inference.speculative import _set_index_counters
from tfde_tpu.models.gpt import gpt_tiny_test as j_tiny
from tfde_tpu_torch.inference.decode import generate, init_cache
from tfde_tpu_torch.inference.server import ContinuousBatcher
from tfde_tpu_torch.models.flax_weights import from_flax_params
from tfde_tpu_torch.models.gpt import gpt_tiny_test
from tfde_tpu_torch.models.transformer import Encoder
from tfde_tpu_torch.testing import one_thread

#: one intra-op torch thread for the module (`testing.one_thread`)
_one_thread = pytest.fixture(autouse=True, scope="module")(one_thread)

CONFIGS = {
    "rope": dict(position="rope", rope_theta=500.0,
                 rope_scaling=("linear", 2.0), rope_dim=4),
    "gqa": dict(num_kv_heads=2),
    "window": dict(sliding_window=5),
    "alternate": dict(sliding_window=5, sliding_window_pattern="alternate"),
    "rope_gqa_window": dict(position="rope", num_kv_heads=2,
                            sliding_window=5),
}
DECODE = ("rope", "gqa", "window", "rope_gqa_window")
B, P, MAX_LEN, TICKS = 3, 12, 24, 3


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@functools.cache
def _jax(name):
    """(numpy params, full-sequence logits, [prefill logits, tick logits
    ...], the JAX cache's keys) of `gpt_tiny_test(**CONFIGS[name])`."""
    jm = j_tiny(**CONFIGS[name])
    params = jax.jit(jm.init)(jax.random.key(1),
                              jnp.zeros((1, 8), jnp.int32))["params"]
    full = jax.jit(jm.apply)({"params": params}, jnp.asarray(_ids()))
    decode = []
    keys = None
    if name in DECODE:
        apply = jax.jit(functools.partial(_decode_clone(jm).apply,
                                          mutable=["cache"]))
        cache = j_init_cache(jm, B, MAX_LEN)
        logits, mut = apply({"params": params, "cache": cache},
                            jnp.asarray(_prompt()))
        cache = mut["cache"]
        decode.append(np.asarray(logits))
        idx = _rows()
        for feed in _feeds():
            cache = _set_index_counters(cache, idx.astype(np.int32))
            logits, mut = apply({"params": params, "cache": cache},
                                jnp.asarray(feed))
            cache = mut["cache"]
            decode.append(np.asarray(logits))
            idx = idx + 1
        keys = [np.asarray(cache["decoder"][f"block_{i}"]["attn"]
                           ["cached_key"]) for i in range(2)]
    return (jax.tree.map(np.asarray, params), np.asarray(full), decode,
            keys)


def _ids():
    return np.random.default_rng(0).integers(0, 97, (3, 20))


def _prompt():
    return np.random.default_rng(3).integers(0, 97, (B, P))


def _rows():
    """The rows rewound to different committed counts, as the batcher
    holds them."""
    return np.array([P, P - 3, P - 1])


def _feeds():
    rng = np.random.default_rng(4)
    return [rng.integers(0, 97, (B, 1)) for _ in range(TICKS)]


def _port(name):
    params = _jax(name)[0]
    model = gpt_tiny_test(device="cpu", **CONFIGS[name])
    model.load_state_dict(from_flax_params(params))
    return model


@pytest.mark.parametrize("name", CONFIGS)
def test_converted_state_dict_covers_the_port(name):
    sd = from_flax_params(_jax(name)[0])
    model = gpt_tiny_test(device="cpu", **CONFIGS[name])
    assert {k: tuple(v.shape) for k, v in sd.items()} \
        == {k: tuple(v.shape) for k, v in model.state_dict().items()}
    kv = CONFIGS[name].get("num_kv_heads", 4)
    assert model.decoder.block_0.attn.key.weight.shape == (kv * 8, 32)
    assert ("wpe.weight" in sd) == ("position" not in CONFIGS[name])


@pytest.mark.parametrize("impl", ["reference", "flash"])
@pytest.mark.parametrize("name", CONFIGS)
def test_full_sequence_logits_match_jax(name, impl):
    model = _port(name)
    model.set_attn_impl(impl)
    with torch.no_grad():
        got = model(torch.as_tensor(_ids()))
    assert _rel(got.numpy(), _jax(name)[1]) <= 1e-5


@pytest.mark.parametrize("impl", ["reference", "flash"])
@pytest.mark.parametrize("name", DECODE)
def test_prefill_and_per_row_decode_match_jax(name, impl):
    """A shared-index prefill into a fresh cache (rope positions 0..P-1,
    the window passed to the dispatcher), then per-row ticks (rope at each
    row's own position, the band over the cache), against the JAX decode
    clone; then the cache's written keys (rotated, Kv heads wide)."""
    _, _, want, jkeys = _jax(name)
    model = _port(name)
    model.set_attn_impl(impl)
    cache = init_cache(model, B, MAX_LEN)
    assert cache.keys[0].shape == (B, MAX_LEN, model.kv_heads, 8)
    with torch.no_grad():
        got = model(torch.as_tensor(_prompt()), cache=cache)
        assert _rel(got.numpy(), want[0]) <= 1e-5
        idx = _rows()
        for feed, w in zip(_feeds(), want[1:]):
            cache.set_index(torch.as_tensor(idx))
            got = model(torch.as_tensor(feed), cache=cache)
            assert _rel(got.numpy(), w) <= 1e-5
            idx = idx + 1
    for layer in range(2):
        for r in range(B):
            n = int(idx[r])
            assert _rel(cache.keys[layer][r, :n].numpy(),
                        jkeys[layer][r, :n]) <= 1e-5


def test_batcher_serves_the_combined_model_as_generate():
    """Rope + GQA + window through the batcher (bucketed admission
    prefill, per-row ticks) against solo `generate`, greedy."""
    model = _port("rope_gqa_window")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 97, p) for p in (3, 11, 6, 9)]
    srv = ContinuousBatcher(model, batch_size=2, max_len=32, scan_depth=4,
                            device="cpu")
    rids = [srv.submit(p, 12) for p in prompts]
    done = dict(srv.run())
    for rid, p in zip(rids, prompts):
        toks, lens = generate(model, p[None], 12, device="cpu")
        np.testing.assert_array_equal(done[rid],
                                      toks[0, p.size:int(lens[0])].numpy())


def test_rope_model_has_no_position_budget():
    """A rotary model has no position table: the cache budget may pass
    max_position (64), as in JAX's validate_budget."""
    model = _port("rope")
    toks, lens = generate(model, np.zeros((1, 60), np.int64), 8,
                          device="cpu")
    assert toks.shape == (1, 68) and int(lens[0]) == 68
    with pytest.raises(ValueError, match="max_position"):
        generate(_port("gqa"), np.zeros((1, 60), np.int64), 8,
                 device="cpu")


@pytest.mark.parametrize("kw,match", [
    (dict(num_kv_heads=3), "divide"), (dict(num_kv_heads=-2), "positive"),
    (dict(position="alibi"), "position"),
    (dict(sliding_window=4, sliding_window_pattern="every3"),
     "window_pattern"),
])
def test_bad_values_raise_as_in_jax(kw, match):
    with pytest.raises(ValueError, match=match):
        gpt_tiny_test(device="cpu", **kw)


def test_window_requires_causal():
    with pytest.raises(ValueError, match="causal"):
        Encoder(1, 32, 4, 8, 64, torch.float32, window=4, device="cpu")
