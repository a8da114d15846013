"""The port's shared encoder (tfde_tpu_torch/models/transformer.py: the
causal flag, the attention mask, post-LN, dropout) and the attention
dispatch's non-causal path, held against the JAX package.

Pre-LN and post-LN `Encoder`s of two blocks, with and without a padding
mask, causal and not, on the same weights (`from_flax_params`) and the
same numpy inputs: fp32 outputs at 1e-5 relative Frobenius. Dropout: off
at rate 0 or outside training, drawn from the generator it is given.
The dispatch: `auto` on a CUDA tensor takes the flash kernels for
unmasked non-causal self-attention of a shape they take (head dim 64 or
128, query heads a multiple of the KV heads, fp32 or bf16), and the
reference einsum for a masked call or any other non-causal shape; the
causal path is unchanged (flash on CUDA whatever the shape, whose
wrapper raises on what it cannot take). A CPU tensor drives the CUDA
branch by reporting a CUDA device, and the two implementations are
recorded in place of running.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfde_tpu.models.transformer import Encoder as JEncoder
from tfde_tpu.ops.attention import padding_mask as j_padding_mask
from tfde_tpu_torch.models.flax_weights import from_flax_params
from tfde_tpu_torch.models.transformer import (
    Encoder, TransformerBlock, init_flax_)
from tfde_tpu_torch.ops import attention as tattn
from tfde_tpu_torch.testing import one_thread

#: one intra-op torch thread for the module (`testing.one_thread`)
_one_thread = pytest.fixture(autouse=True, scope="module")(one_thread)

DEPTH, HEADS, HEAD_DIM, MLP, B, S = 2, 4, 8, 64, 3, 12


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _inputs():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, S, HEADS * HEAD_DIM)).astype(np.float32)
    valid = np.ones((B, S), np.float32)
    valid[0, 9:] = 0.0
    valid[2, 5:] = 0.0
    return x, valid


def _port(norm_style, causal, params, **kw):
    enc = Encoder(DEPTH, HEADS * HEAD_DIM, HEADS, HEAD_DIM, MLP,
                  torch.float32, causal=causal, norm_style=norm_style,
                  device="cpu", **kw)
    enc.load_state_dict(from_flax_params(params))
    return enc


@pytest.mark.parametrize("norm_style", ["pre", "post"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("causal", [False, True])
def test_encoder_matches_jax(norm_style, masked, causal):
    x, valid = _inputs()
    jm = JEncoder(depth=DEPTH, num_heads=HEADS, head_dim=HEAD_DIM,
                  mlp_dim=MLP, dtype=jnp.float32, causal=causal,
                  norm_style=norm_style)
    jmask = j_padding_mask(jnp.asarray(valid)) if masked else None
    params = jm.init(jax.random.key(1), jnp.asarray(x), mask=jmask)["params"]
    params = jax.tree.map(np.asarray, params)
    assert ("ln_final" in params) == (norm_style == "pre")
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x),
                               mask=jmask))
    enc = _port(norm_style, causal, params)
    mask = tattn.padding_mask(torch.as_tensor(valid)) if masked else None
    got = enc(torch.as_tensor(x), mask=mask).detach().numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    assert _rel(got, want) <= 1e-5


def test_post_ln_block_ends_normalised_in_the_compute_dtype():
    """A post-LN block's output is its last LayerNorm's, cast to the
    compute dtype (flax: `.astype(self.dtype)`): zero mean, unit variance
    a row at unit scale and zero bias."""
    block = TransformerBlock(32, 4, 8, 64, torch.bfloat16,
                             norm_style="post", device="cpu")
    init_flax_(block, torch.Generator().manual_seed(0))
    x = torch.randn(2, 5, 32).to(torch.bfloat16)
    with torch.no_grad():
        y = block(x)
    assert y.dtype == torch.bfloat16
    yf = y.float()
    assert float(yf.mean(-1).abs().max()) < 2e-2
    assert float((yf.var(-1, unbiased=False) - 1).abs().max()) < 5e-2


def test_dropout_is_off_outside_training_and_drawn_from_the_generator():
    x, _ = _inputs()
    x = torch.as_tensor(x)
    enc = Encoder(DEPTH, HEADS * HEAD_DIM, HEADS, HEAD_DIM, MLP,
                  torch.float32, dropout_rate=0.3, device="cpu")
    init_flax_(enc, torch.Generator().manual_seed(0))
    base = enc(x)
    assert torch.equal(enc(x, train=False), base)
    runs = [enc(x, train=True,
                generator=torch.Generator().manual_seed(s)).detach()
            for s in (7, 7, 8)]
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])
    assert not torch.allclose(runs[0], base.detach())
    with pytest.raises(ValueError, match="Generator"):
        enc(x, train=True)
    zero = Encoder(DEPTH, HEADS * HEAD_DIM, HEADS, HEAD_DIM, MLP,
                   torch.float32, device="cpu")
    zero.load_state_dict(enc.state_dict())
    assert torch.equal(zero(x, train=True), base)


@pytest.mark.parametrize("field,value", [
    ("quant", "int8"), ("fused_qkv", True), ("paged_blocks", 16),
    ("kv_block", 32), ("kv_quant", "int8")])
def test_unported_fields_raise(field, value):
    with pytest.raises(NotImplementedError, match=field):
        Encoder(1, 32, 4, 8, 64, torch.float32, device="cpu",
                **{field: value})
    with pytest.raises(ValueError, match="norm_style"):
        Encoder(1, 32, 4, 8, 64, torch.float32, norm_style="bogus",
                device="cpu")
    with pytest.raises(TypeError, match="bogus"):
        TransformerBlock(32, 4, 8, 64, torch.float32, device="cpu", bogus=1)


class _ReportsCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device: it drives the dispatcher's
    CUDA branch here without a card."""

    @property
    def device(self):
        return torch.device("cuda")


#: (B, Sq, Sk, H, KV, D, dtype, causal, masked) -> the implementation
#: `auto` must take
DISPATCH = {
    "bert": ((4, 128, 128, 12, 12, 64, torch.bfloat16, False, False),
             "flash"),
    "vit_ragged": ((2, 197, 197, 12, 12, 64, torch.bfloat16, False, False),
                   "flash"),
    "d128_fp32": ((2, 16, 16, 4, 4, 128, torch.float32, False, False),
                  "flash"),
    "gqa": ((2, 16, 16, 8, 2, 64, torch.bfloat16, False, False), "flash"),
    "masked": ((2, 16, 16, 4, 4, 64, torch.bfloat16, False, True),
               "reference"),
    "head_dim_8": ((2, 16, 16, 4, 4, 8, torch.float32, False, False),
                   "reference"),
    "cross": ((2, 16, 24, 4, 4, 64, torch.bfloat16, False, False),
              "reference"),
    "fp16": ((2, 16, 16, 4, 4, 64, torch.float16, False, False),
             "reference"),
    "causal_head_dim_8": ((2, 16, 16, 4, 4, 8, torch.float32, True, False),
                          "flash"),
    "causal_masked": ((2, 16, 16, 4, 4, 64, torch.bfloat16, True, True),
                      "reference"),
}


@pytest.mark.parametrize("case", list(DISPATCH))
def test_auto_dispatch_on_a_cuda_tensor(case, monkeypatch):
    (b, sq, sk, h, kv, d, dtype, causal, masked), want = DISPATCH[case]
    took = []
    monkeypatch.setattr(tattn.fa, "flash_attention",
                        lambda q, k, v, **kw: took.append("flash") or q)
    monkeypatch.setattr(tattn, "reference_attention",
                        lambda q, k, v, **kw: took.append("reference") or q)
    q = torch.zeros((b, sq, h, d), dtype=dtype).as_subclass(_ReportsCuda)
    k, v = (torch.zeros((b, sk, kv, d), dtype=dtype).as_subclass(
        _ReportsCuda) for _ in range(2))
    mask = torch.ones((b, 1, 1, sk), dtype=torch.bool) if masked else None
    tattn.attention(q, k, v, mask=mask, causal=causal, impl="auto")
    assert took == [want]
    took.clear()
    tattn.attention(q.as_subclass(torch.Tensor), k.as_subclass(torch.Tensor),
                    v.as_subclass(torch.Tensor), mask=mask, causal=causal,
                    impl="auto")
    assert took == ["reference"]  # a CPU tensor takes the plain einsum


def test_flash_impl_keeps_refusing_a_mask():
    q = torch.zeros((1, 8, 2, 64))
    with pytest.raises(NotImplementedError, match="mask"):
        tattn.attention(q, q, q, mask=torch.ones(8, 8, dtype=torch.bool),
                        impl="flash")
