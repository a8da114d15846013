"""The port's GPT (tfde_tpu_torch/models) on the JAX package's weights.

`from_flax_params` carries `gpt_tiny_test`'s flax params into the port's
state_dict; the port's full-sequence logits and its cached prefill plus
per-row decode ticks are then held against `GPT.apply` and the JAX decode
clone within 1e-5 relative Frobenius, fp32 on the CPU, both attention
implementations. Fields outside the ported slice must raise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfde_tpu.inference.decode import _decode_clone
from tfde_tpu.inference.decode import init_cache as j_init_cache
from tfde_tpu.inference.speculative import _set_index_counters
from tfde_tpu.models.gpt import gpt_tiny_test as j_tiny
from tfde_tpu_torch.inference.decode import init_cache
from tfde_tpu_torch.models.flax_weights import from_flax_params
from tfde_tpu_torch.models.gpt import _UNPORTED, GPT, gpt_tiny_test


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(scope="module")
def pair():
    jm = j_tiny()
    params = jm.init(jax.random.key(1), jnp.zeros((1, 8), jnp.int32))["params"]
    tm = gpt_tiny_test(device="cpu")
    tm.load_state_dict(from_flax_params(jax.tree.map(np.asarray, params)))
    return jm, params, tm


def test_converted_state_dict_covers_the_port(pair):
    _jm, params, tm = pair
    sd = from_flax_params(jax.tree.map(np.asarray, params))
    assert {k: tuple(v.shape) for k, v in sd.items()} \
        == {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    assert all(v.dtype == torch.float32 for v in sd.values())


@pytest.mark.parametrize("impl", ["reference", "flash"])
def test_full_sequence_logits_match_jax(pair, impl):
    jm, params, tm = pair
    ids = np.random.default_rng(0).integers(0, 97, (3, 20))
    want = jm.apply({"params": params}, jnp.asarray(ids))
    tm.set_attn_impl(impl)
    try:
        with torch.no_grad():
            got = tm(torch.as_tensor(ids))
    finally:
        tm.set_attn_impl("auto")
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), want) <= 1e-5


@pytest.mark.parametrize("impl", ["reference", "flash"])
def test_prefill_and_per_row_decode_match_jax(pair, impl):
    """A shared-index prefill into a fresh cache (the admission prefill),
    then three per-row ticks with the rows at different positions (the
    batcher's decode), against the JAX decode clone's two branches."""
    jm, params, tm = pair
    rng = np.random.default_rng(2)
    b, p, max_len = 3, 9, 24
    prompt = rng.integers(0, 97, (b, p))
    dm = _decode_clone(jm)
    jcache = j_init_cache(jm, b, max_len)
    jl, mut = dm.apply({"params": params, "cache": jcache},
                       jnp.asarray(prompt), mutable=["cache"])
    jcache = mut["cache"]
    tm.set_attn_impl(impl)
    cache = init_cache(tm, b, max_len)
    try:
        with torch.no_grad():
            tl = tm(torch.as_tensor(prompt), cache=cache)
            assert cache.index == p
            assert _rel(tl.numpy(), jl) <= 1e-5
            # rows rewound to different committed counts, as the batcher
            # holds them
            idx = np.array([p, p - 3, p - 1])
            for _ in range(3):
                feed = rng.integers(0, 97, (b, 1))
                jcache = _set_index_counters(jcache, idx.astype(np.int32))
                jl, mut = dm.apply({"params": params, "cache": jcache},
                                   jnp.asarray(feed), mutable=["cache"])
                jcache = mut["cache"]
                cache.set_index(torch.as_tensor(idx))
                tl = tm(torch.as_tensor(feed), cache=cache)
                assert _rel(tl.numpy(), jl) <= 1e-5
                np.testing.assert_array_equal(cache.index.numpy(), idx + 1)
                idx = idx + 1
    finally:
        tm.set_attn_impl("auto")
    # the cache itself matches the JAX cache on every written position
    for layer in range(tm.depth):
        jk = np.asarray(jcache["decoder"][f"block_{layer}"]["attn"]
                        ["cached_key"])
        for r in range(b):
            n = int(idx[r])
            assert _rel(cache.keys[layer][r, :n].numpy(), jk[r, :n]) <= 1e-5


@pytest.mark.parametrize("field,value", [
    ("position", "rope"), ("num_kv_heads", 2), ("fused_qkv", True),
    ("quant", "int8"), ("sliding_window", 8), ("paged_blocks", 16),
    ("kv_quant", "int8"), ("num_experts", 4), ("norm", "rms"),
    ("attn_logit_cap", 30.0),
])
def test_unported_fields_raise(field, value):
    with pytest.raises(NotImplementedError, match=field):
        gpt_tiny_test(device="cpu", **{field: value})
    # the default value of a known field is accepted
    gpt_tiny_test(device="cpu", **{field: _UNPORTED[field]})


def test_unknown_field_raises():
    with pytest.raises(TypeError, match="bogus"):
        gpt_tiny_test(device="cpu", bogus=1)


def test_cast_compute_weights_keeps_logits():
    m = GPT(vocab_size=50, hidden_size=32, depth=1, num_heads=2, mlp_dim=64,
            max_position=16, dtype=torch.bfloat16, device="cpu", seed=4)
    ids = torch.as_tensor(np.random.default_rng(3).integers(0, 50, (2, 10)))
    with torch.no_grad():
        before = m(ids)
        m.cast_compute_weights_()
        after = m(ids)
    assert m.wte.weight.dtype == torch.bfloat16
    assert m.decoder.block_0.ln_attn.weight.dtype == torch.float32
    torch.testing.assert_close(after, before, rtol=0, atol=0)
