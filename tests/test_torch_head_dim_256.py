"""Head dim 256 (Gemma, Gemma-2, GPT-J, Pythia-1B) held against the JAX
package.

The plain versions of the flash kernels at D 256 — what a CPU tensor runs
and what chip_smoke.py holds the D-256 CUDA kernels against on the card —
against the Pallas kernels in interpret mode: the forward
(`_flash_forward`) over causal / non-causal x MHA / GQA x window x cap x
scale, the backward against the Pallas pair (`_bwd_pallas`, MHA) and, for
GQA, against `jax.vjp` of the JAX `flash_attention`; out, lse, dq, dk and
dv within 1e-5 relative Frobenius, S = 64 in 32-row tiles, fp32. Then a
2-layer Gemma-2-shaped GPT with head_dim 256 (the field set
`models.convert.gemma2_from_hf` makes: sandwich RMSNorms, geglu,
embed_scale, query_pre_attn_scalar 256, both softcaps, the alternating
window, GQA) on the JAX model's weights: full-sequence logits with both
attention implementations within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfde_tpu.models.gpt import GPT as JGPT
from tfde_tpu.ops import flash_attention as jfa
from tfde_tpu_torch.models.flax_weights import from_flax_params
from tfde_tpu_torch.models.gpt import GPT
from tfde_tpu_torch.ops import flash_attention as tfa
from tfde_tpu_torch.testing import one_thread

#: one intra-op torch thread for the module (`testing.one_thread`)
_one_thread = pytest.fixture(autouse=True, scope="module")(one_thread)

D, S, TILE, TOL = 256, 64, 32, 1e-5


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _arrays(seed, h, kv, b=1):
    """q, k, v and an output gradient dO at D 256, fp32 numpy."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, S, h, D), (b, S, kv, D), (b, S, kv, D),
                          (b, S, h, D))]


# (name, causal, window, scale, cap, kv heads of 4 query heads)
CASES = [
    ("causal", True, None, None, None, 4),
    ("bidir_gqa", False, None, None, None, 2),
    ("window_gqa_cap_scale", True, 24, 1 / 16, 50.0, 2),
    ("cap_mqa", True, None, None, 30.0, 1),
]


@pytest.mark.parametrize("name,causal,window,scale,cap,kv", CASES,
                         ids=[c[0] for c in CASES])
def test_plain_forward_matches_pallas_at_d256(name, causal, window, scale,
                                              cap, kv):
    q, k, v, _ = _arrays(sum(map(ord, name)), 4, kv)
    want_out, want_lse = jfa._flash_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, TILE, TILE,
        True, window, scale, cap)
    out, lse = tfa.flash_forward(torch.as_tensor(q), torch.as_tensor(k),
                                 torch.as_tensor(v), causal, window, scale,
                                 cap)
    assert out.shape == q.shape and lse.shape == want_lse.shape
    assert _rel(out.numpy(), want_out) <= TOL
    assert _rel(lse.numpy(), want_lse) <= TOL


# (name, causal, window, scale, cap): MHA, the Pallas pair
PALLAS_CASES = [
    ("bidir", False, None, None, None),
    ("window_cap_scale", True, 24, 1 / 16, 50.0),
]


@pytest.mark.parametrize("name,causal,window,scale,cap", PALLAS_CASES,
                         ids=[c[0] for c in PALLAS_CASES])
def test_plain_backward_matches_the_pallas_pair_at_d256(name, causal, window,
                                                       scale, cap):
    q, k, v, do = _arrays(sum(map(ord, name)), 2, 2)
    jq, jk, jv, jdo = (jnp.asarray(t) for t in (q, k, v, do))
    out, lse = jfa._flash_forward(jq, jk, jv, causal, TILE, TILE, True,
                                  window, scale, cap)
    want = jfa._bwd_pallas((jq, jk, jv, out, lse), jdo, causal=causal,
                           block_q=TILE, block_k=TILE, interpret=True,
                           window=window, scale=scale, logit_cap=cap)
    got = tfa.flash_backward(
        *(torch.as_tensor(np.array(t)) for t in (q, k, v, out, lse, do)),
        causal, window, scale, cap)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert _rel(g.numpy(), w) <= TOL


def test_gqa_gradient_matches_the_jax_vjp_at_d256():
    """Autograd through the port's flash_attention (the forward op's
    formula: the plain backward on the CPU) against `jax.vjp` of the JAX
    `flash_attention`, GQA 4 -> 2, causal, window, cap, scale."""
    q, k, v, do = _arrays(13, 4, 2)
    opts = (True, 24, 1 / 16, 50.0)

    def jax_flash(a, b, c):
        return jfa.flash_attention(a, b, c, opts[0], TILE, TILE, True,
                                   window=opts[1], scale=opts[2],
                                   logit_cap=opts[3])

    _, vjp = jax.vjp(jax_flash, jnp.asarray(q), jnp.asarray(k),
                     jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    leaves = [torch.as_tensor(t).requires_grad_() for t in (q, k, v)]
    out = tfa.flash_attention(*leaves, *opts)
    got = torch.autograd.grad(out, leaves, torch.as_tensor(do))
    for g, w in zip(got, want):
        assert _rel(g.numpy(), w) <= TOL


#: the field set `gemma2_from_hf` builds from a Gemma-2 config, at two
#: layers and head dim 256 (decoupled from hidden 256 over 4 heads -> 2
#: KV heads)
GEMMA2_256 = dict(
    vocab_size=256, hidden_size=256, depth=2, num_heads=4, num_kv_heads=2,
    head_dim=256, mlp_dim=512, max_position=128, position="rope",
    rope_theta=10000.0, norm="rms", norm_style="sandwich", mlp_act="geglu",
    use_bias=False, tie_embeddings=True, embed_scale=256 ** 0.5,
    ln_eps=1e-6, sliding_window=16, sliding_window_pattern="alternate",
    attn_scale=256 ** -0.5, attn_logit_cap=50.0, final_logit_cap=30.0)


@pytest.fixture(scope="module")
def gemma2():
    """(the port's GPT on the JAX model's weights, token ids of 40 — past
    the window of 16 on the even layer — and the JAX logits on them),
    fp32."""
    jm = JGPT(**GEMMA2_256, dtype=jnp.float32)
    params = jax.jit(jm.init)(jax.random.key(2), jnp.zeros((1, 8), jnp.int32))
    params = jax.tree.map(np.asarray, params["params"])
    tm = GPT(**GEMMA2_256, dtype=torch.float32, device="cpu")
    tm.load_state_dict(from_flax_params(params))
    ids = np.random.default_rng(0).integers(0, 256, (2, 40))
    want = jax.jit(jm.apply)({"params": params}, jnp.asarray(ids))
    return tm, ids, np.asarray(want)


@pytest.mark.parametrize("impl", ["reference", "flash"])
def test_gemma2_shaped_logits_match_jax(gemma2, impl):
    tm, ids, want = gemma2
    assert tm.head_dim == D
    tm.set_attn_impl(impl)
    try:
        with torch.no_grad():
            got = tm(torch.as_tensor(ids))
    finally:
        tm.set_attn_impl("auto")
    assert _rel(got.numpy(), want) <= TOL
