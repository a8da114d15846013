"""The decoder fields of the converted checkpoint families, held against
the JAX `GPT` on the same weights.

One small fp32 config per field group (`testing.FIELD_GROUPS`, the
configs of `chip_smoke.py`'s hf_serve phase): rms norms and swiglu with
GQA and llama3 rope scaling, qk_norm with a decoupled head_dim, qkv_bias,
Gemma-2's sandwich norms, geglu, embed_scale, attn_scale and softcaps
under the alternating window, Phi's parallel block with partial rope and
an untied biased head, NeoX's two-norm parallel residual, BigCode's one
KV head, OPT's relu. The JAX params go through `from_flax_params`; the
port's full-sequence logits (both attention implementations), its
shared-index prefill then per-row decode ticks (against the JAX decode
clone's two branches, and the cache itself), and the llama-style
config's gradient are held within 1e-5 relative Frobenius, as
`tests/test_torch_gpt.py` holds GPT-2's. `to_flax_params` is the exact
inverse of `from_flax_params`. Also: the flash wrappers' zero padding of
head dims 80 and 96 against the unpadded plain versions, the full-width
parameter counts of the two checkpoints the card serves, and the
refusals.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from tfde_tpu.inference.decode import _decode_clone
from tfde_tpu.inference.decode import init_cache as j_init_cache
from tfde_tpu.inference.speculative import _set_index_counters
from tfde_tpu.models.gpt import GPT as JGPT
from tfde_tpu_torch.inference.decode import init_cache
from tfde_tpu_torch.models.flax_weights import (
    from_flax_params, to_flax_params)
from tfde_tpu_torch.models.gpt import GPT
from tfde_tpu_torch.models.transformer import TransformerBlock
from tfde_tpu_torch.ops import flash_attention as fa
from tfde_tpu_torch.testing import FIELD_GROUPS, FULL_WIDTH
from tfde_tpu_torch.testing import one_thread

#: one intra-op torch thread for the module (`testing.one_thread`)
_one_thread = pytest.fixture(autouse=True, scope="module")(one_thread)

TOL = 1e-5


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _leaves(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(value)


@pytest.fixture(scope="module", params=sorted(FIELD_GROUPS))
def pair(request):
    """(group, JAX GPT, its params, the port's GPT on them), fp32."""
    _family, fields = FIELD_GROUPS[request.param]
    jm = JGPT(**fields, dtype=jnp.float32)
    params = jax.jit(jm.init)(jax.random.key(1), jnp.zeros((1, 8), jnp.int32))
    params = jax.tree.map(np.asarray, params["params"])
    tm = GPT(**fields, dtype=torch.float32, device="cpu")
    tm.load_state_dict(from_flax_params(params))
    return request.param, jm, params, tm


@pytest.mark.parametrize("impl", ["reference", "flash"])
def test_full_sequence_logits_match_jax(pair, impl):
    # 40 tokens: past Gemma-2's window of 16
    _group, jm, params, tm = pair
    ids = np.random.default_rng(0).integers(0, 256, (2, 40))
    want = jax.jit(jm.apply)({"params": params}, jnp.asarray(ids))
    tm.set_attn_impl(impl)
    try:
        with torch.no_grad():
            got = tm(torch.as_tensor(ids))
    finally:
        tm.set_attn_impl("auto")
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), want) <= TOL


def test_prefill_and_per_row_decode_match_jax(pair):
    """A shared-index prefill into a fresh cache (the admission prefill),
    then three per-row ticks with the rows at different positions (the
    batcher's decode), against the JAX decode clone's two branches; then
    the cached keys (normed and rotated under qk_norm) against JAX's."""
    _group, jm, params, tm = pair
    rng = np.random.default_rng(2)
    b, p, max_len = 3, 21, 32
    prompt = rng.integers(0, 256, (b, p))
    step = jax.jit(functools.partial(_decode_clone(jm).apply,
                                     mutable=["cache"]))
    jcache = j_init_cache(jm, b, max_len)
    jl, mut = step({"params": params, "cache": jcache}, jnp.asarray(prompt))
    jcache = mut["cache"]
    cache = init_cache(tm, b, max_len)
    assert cache.keys[0].shape == (b, max_len, tm.kv_heads, tm.head_dim)
    with torch.no_grad():
        tl = tm(torch.as_tensor(prompt), cache=cache)
        assert _rel(tl.numpy(), jl) <= TOL
        idx = np.array([p, p - 3, p - 1])
        for _ in range(3):
            feed = rng.integers(0, 256, (b, 1))
            jcache = _set_index_counters(jcache, idx.astype(np.int32))
            jl, mut = step({"params": params, "cache": jcache},
                           jnp.asarray(feed))
            jcache = mut["cache"]
            cache.set_index(torch.as_tensor(idx))
            tl = tm(torch.as_tensor(feed), cache=cache)
            assert _rel(tl.numpy(), jl) <= TOL
            idx = idx + 1
    for layer in range(tm.depth):
        jk = np.asarray(jcache["decoder"][f"block_{layer}"]["attn"]
                        ["cached_key"])
        for r in range(b):
            n = int(idx[r])
            assert _rel(cache.keys[layer][r, :n].numpy(), jk[r, :n]) <= TOL


def test_flax_layout_round_trips_bit_for_bit(pair):
    """`to_flax_params` gives back the JAX tree exactly, and
    `from_flax_params` of it the port's state_dict exactly."""
    _group, _jm, params, tm = pair
    tree = to_flax_params(tm)
    got, want = dict(_leaves(tree)), dict(_leaves(params))
    assert got.keys() == want.keys()
    for path, value in want.items():
        assert got[path].dtype == np.float32
        np.testing.assert_array_equal(got[path], value, err_msg=str(path))
    sd = from_flax_params(tree)
    assert sd.keys() == tm.state_dict().keys()
    for name, value in tm.state_dict().items():
        assert torch.equal(sd[name], value), name


def test_llama_style_gradient_matches_jax():
    """The gradient of sum(logits * w) with respect to every parameter of
    the llama-style config (rms, swiglu, no bias, GQA, rope scaling, an
    untied head), through the flash path's plain versions on the CPU."""
    _family, fields = FIELD_GROUPS["llama"]
    jm = JGPT(**fields, dtype=jnp.float32)
    params = jax.jit(jm.init)(jax.random.key(3), jnp.zeros((1, 8), jnp.int32))
    params = params["params"]
    rng = np.random.default_rng(4)
    ids = rng.integers(0, 256, (2, 24))
    w = rng.standard_normal((2, 24, 256)).astype(np.float32)

    def loss(p):
        return jnp.sum(jm.apply({"params": p}, jnp.asarray(ids)) * w)

    jgrads = jax.jit(jax.grad(loss))(params)
    jgrads = from_flax_params(jax.tree.map(np.asarray, jgrads))
    tm = GPT(**fields, dtype=torch.float32, device="cpu")
    tm.load_state_dict(from_flax_params(jax.tree.map(np.asarray, params)))
    tm.set_attn_impl("flash")
    (tm(torch.as_tensor(ids)) * torch.as_tensor(w)).sum().backward()
    grads = {n: p.grad for n, p in tm.named_parameters()}
    assert grads.keys() == jgrads.keys()
    total = np.sqrt(sum(float(g.double().norm()) ** 2
                        for g in jgrads.values()))
    for name, want in jgrads.items():
        assert float(want.norm()) > 1e-3 * total, name
        assert _rel(grads[name].numpy(), want.numpy()) <= TOL, name


# ---------------------------------------------- the head-dim padding ----

@pytest.mark.parametrize("d,heads,kv,s", [(80, 4, 4, 37), (96, 4, 2, 33)])
@pytest.mark.parametrize("causal,window,cap", [
    (True, None, None), (True, 9, 5.0), (False, None, None)])
def test_padding_equals_the_unpadded_plain_versions(d, heads, kv, s, causal,
                                                    window, cap):
    """`padded_forward`/`padded_backward` (what the CUDA wrappers run a
    head dim of 80 or 96 through) over the plain versions, at head dim
    128, equal the plain versions at the real head dim: out, lse, dq, dk,
    dv, at the real head dim's scale."""
    rng = np.random.default_rng(d + s)
    q, k, v, do = (torch.as_tensor(rng.standard_normal(
        (2, s, n, d)).astype(np.float32)) for n in (heads, kv, kv, heads))
    scale = 1.0 / np.sqrt(d)
    seen = []

    def forward(*args):
        seen.append(args[0].shape[-1])
        return fa.flash_forward_reference(*args)

    def backward(*args):
        seen.append(args[0].shape[-1])
        return fa.flash_backward_reference(*args)

    opts = (causal, window, scale, cap)
    out, lse = fa.padded_forward(forward, q, k, v, *opts)
    want_out, want_lse = fa.flash_forward_reference(q, k, v, *opts)
    assert out.shape == q.shape and out.is_contiguous()
    assert _rel(out.numpy(), want_out.numpy()) <= 1e-6
    assert float((lse - want_lse).abs().max()) <= 1e-5
    grads = fa.padded_backward(backward, q, k, v, out, lse, do, *opts)
    wants = fa.flash_backward_reference(q, k, v, want_out, want_lse, do,
                                        *opts)
    for got, want in zip(grads, wants):
        assert got.shape == want.shape
        assert _rel(got.numpy(), want.numpy()) <= 1e-6
    assert seen == [128, 128]


def test_kernel_head_dims():
    assert [fa.kernel_head_dim(d) for d in (8, 64, 80, 96, 128, 160, 256)] \
        == [64, 64, 128, 128, 128, 256, 256]
    with pytest.raises(ValueError, match="head dims above 256"):
        fa.kernel_head_dim(320)


# --------------------------------------------------- full width, refusals --

class _OnMeta(TorchFunctionMode):
    """Every tensor a factory makes lands on the meta device whatever
    device it names: a full-width model's shapes without its storage."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if kwargs.get("device") is not None:
            kwargs = {**kwargs, "device": "meta"}
        return func(*args, **kwargs)


@pytest.mark.parametrize("name,count", [("Llama-3.2-1B", 1_235_814_400),
                                        ("Qwen3-0.6B", 596_049_920),
                                        ("Gemma-2-2B", 2_614_341_888)])
def test_full_width_parameter_counts(name, count):
    _family, fields = FULL_WIDTH[name]
    with _OnMeta():
        model = GPT(**fields, device="cpu")
    assert model.wte.weight.is_meta
    assert sum(p.numel() for p in model.parameters()) == count


def test_refusals():
    with pytest.raises(ValueError, match="head_bias=True requires"):
        GPT(vocab_size=16, hidden_size=16, depth=1, num_heads=2, mlp_dim=32,
            head_bias=True, device="cpu")
    with pytest.raises(ValueError, match="norm must be"):
        GPT(vocab_size=16, hidden_size=16, depth=1, num_heads=2, mlp_dim=32,
            norm="batch", device="cpu")
    with pytest.raises(ValueError, match="act must be"):
        GPT(vocab_size=16, hidden_size=16, depth=1, num_heads=2, mlp_dim=32,
            mlp_act="gelu_exact", device="cpu")
    with pytest.raises(ValueError, match="num_heads"):
        GPT(vocab_size=16, hidden_size=18, depth=1, num_heads=4, mlp_dim=32,
            device="cpu")
    # the JAX block's MoE refusal keeps its wording
    with pytest.raises(NotImplementedError, match="MoE expert MLPs"):
        TransformerBlock(16, 2, 8, 32, torch.float32, mlp_act="geglu",
                         num_experts=4, device="cpu")
