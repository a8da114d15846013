"""Transformer blocks — counterpart of `tfde_tpu/models/transformer.py`.

Ported: `MultiHeadAttention` (MHA, learned positions, with the dense
decode cache: the scalar-index prefill branch and the per-row-index
branch), `Mlp` (tanh gelu), `TransformerBlock` (norm_style='pre') and
`Encoder`. The dtype policy is the JAX one: parameters in fp32, matmuls
in the compute dtype (bf16 by default), LayerNorm in fp32. Flax layouts
map onto torch ones in `models/flax_weights.py`: the DenseGeneral q/k/v
kernels [E, H, D] become Linear weights [H*D, E], `out` [H, D, E] becomes
[E, H*D], Dense [in, out] becomes Linear [out, in].

The KV cache is an explicit object (inference/decode.KVCache) passed down
the stack with the layer number, where flax keeps it in the "cache"
collection; its `index` is a Python int (one shared position — `generate`
and the admission prefill) or a [B] tensor (per-row positions — the
batcher's decode ticks).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tfde_tpu_torch.ops import attention as attn_lib


class Dense(nn.Module):
    """Linear layer with fp32 parameters computed in `dtype` (flax's
    Dense(dtype=..., param_dtype=float32): inputs, kernel and bias cast to
    `dtype`). The weights may be cast to `dtype` once
    (`GPT.cast_compute_weights_`), which gives the same values as the
    per-call cast."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype, bias: bool = True, device=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(
            torch.empty(out_features, in_features, device=device))
        self.bias = (nn.Parameter(torch.zeros(out_features, device=device))
                     if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), b)


class LayerNorm(nn.LayerNorm):
    """LayerNorm computed in fp32 whatever the input dtype; returns fp32
    (flax nn.LayerNorm(dtype=float32))."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps)


class MultiHeadAttention(nn.Module):
    """Causal self-attention with the dispatchable kernel
    (ops/attention.attention) and the dense decode cache."""

    def __init__(self, embed: int, num_heads: int, head_dim: int,
                 dtype: torch.dtype, attn_impl: str = "auto",
                 causal: bool = True, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = head_dim
        self.attn_impl = attn_impl
        self.causal = causal
        width = num_heads * head_dim
        self.query = Dense(embed, width, dtype, device=device)
        self.key = Dense(embed, width, dtype, device=device)
        self.value = Dense(embed, width, dtype, device=device)
        self.out = Dense(width, embed, dtype, device=device)

    def forward(self, x: torch.Tensor, cache=None, layer: int = 0
                ) -> torch.Tensor:
        b, s, _ = x.shape
        shape = (b, s, self.num_heads, self.head_dim)
        q = self.query(x).view(shape)
        k = self.key(x).view(shape)
        v = self.value(x).view(shape)
        if cache is None:
            y = attn_lib.attention(q, k, v, causal=self.causal,
                                   impl=self.attn_impl)
        else:
            if not self.causal:
                raise ValueError("decode requires causal attention")
            y = self._decode_attention(q, k, v, cache, layer)
        return self.out(y.reshape(b, s, -1))

    def _decode_attention(self, q, k, v, cache, layer: int) -> torch.Tensor:
        """Write this call's K/V into the cache at `cache.index`, attend q
        over the filled prefix under the validity mask `j <= index + i`.

        The write is in place (the JAX program's dynamic_update_slice
        without the copy of the whole cache); like
        dynamic_update_slice, a start past `max_len - S` is clamped.

        A shared index of 0 is a prefill into a fresh row cache: columns
        past S are masked out, so the function is plain causal
        self-attention over this call's own q/k/v — it goes through the
        dispatcher, and on a CUDA tensor to the flash kernel. Every other
        call (per-row decode ticks) is the masked einsum over the cache."""
        keys, values = cache.keys[layer], cache.values[layer]
        sq = q.shape[1]
        max_len = keys.shape[1]
        if sq > max_len:
            raise ValueError(
                f"input length {sq} exceeds the cache budget {max_len}; "
                f"re-init the cache with a larger max_len")
        k_w, v_w = k.to(keys.dtype), v.to(values.dtype)
        idx = cache.index
        cols = torch.arange(max_len, device=q.device)
        steps = torch.arange(sq, device=q.device)
        if isinstance(idx, int):
            start = min(max(idx, 0), max_len - sq)
            keys[:, start:start + sq] = k_w
            values[:, start:start + sq] = v_w
            if idx == 0:
                return attn_lib.attention(q, k_w, v_w, causal=True,
                                          impl=self.attn_impl)
            valid = (cols[None, :] <= (idx + steps)[:, None])[None, None]
        else:
            start = idx.clamp(0, max_len - sq)
            rows = torch.arange(q.shape[0], device=q.device)[:, None]
            keys[rows, start[:, None] + steps] = k_w
            values[rows, start[:, None] + steps] = v_w
            pos = idx[:, None] + steps  # [B, sq]
            valid = (cols[None, None, :] <= pos[:, :, None])[:, None]
        return attn_lib.grouped_attention(q, keys, values, mask=valid)


class Mlp(nn.Module):
    """fc1 -> gelu (tanh approximation, flax nn.gelu's default) -> fc2."""

    def __init__(self, embed: int, mlp_dim: int, dtype: torch.dtype,
                 device=None):
        super().__init__()
        self.fc1 = Dense(embed, mlp_dim, dtype, device=device)
        self.fc2 = Dense(mlp_dim, embed, dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class TransformerBlock(nn.Module):
    """Pre-LN block: x + MHA(LN(x)); x + MLP(LN(x)). The LayerNorms run in
    fp32 and their outputs are cast to the compute dtype."""

    def __init__(self, embed: int, num_heads: int, head_dim: int,
                 mlp_dim: int, dtype: torch.dtype, attn_impl: str = "auto",
                 ln_eps: float = 1e-6, device=None):
        super().__init__()
        self.dtype = dtype
        self.ln_attn = LayerNorm(embed, eps=ln_eps, device=device)
        self.attn = MultiHeadAttention(embed, num_heads, head_dim, dtype,
                                       attn_impl=attn_impl, device=device)
        self.ln_mlp = LayerNorm(embed, eps=ln_eps, device=device)
        self.mlp = Mlp(embed, mlp_dim, dtype, device=device)

    def forward(self, x: torch.Tensor, cache=None, layer: int = 0
                ) -> torch.Tensor:
        x = x + self.attn(self.ln_attn(x).to(self.dtype), cache, layer)
        return x + self.mlp(self.ln_mlp(x).to(self.dtype))


class Encoder(nn.Module):
    """`depth` pre-LN blocks (`block_0` ...) and the final fp32 LayerNorm."""

    def __init__(self, depth: int, embed: int, num_heads: int,
                 head_dim: int, mlp_dim: int, dtype: torch.dtype,
                 attn_impl: str = "auto", ln_eps: float = 1e-6,
                 device=None):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            self.add_module(f"block_{i}", TransformerBlock(
                embed, num_heads, head_dim, mlp_dim, dtype,
                attn_impl=attn_impl, ln_eps=ln_eps, device=device))
        self.ln_final = LayerNorm(embed, eps=ln_eps, device=device)

    def blocks(self):
        return [getattr(self, f"block_{i}") for i in range(self.depth)]

    def forward(self, x: torch.Tensor, cache=None) -> torch.Tensor:
        for i, block in enumerate(self.blocks()):
            x = block(x, cache, i)
        return self.ln_final(x)
