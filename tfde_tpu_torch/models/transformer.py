"""Transformer blocks — counterpart of `tfde_tpu/models/transformer.py`.

Ported: `MultiHeadAttention` (with the dense decode cache: the
scalar-index prefill branch and the per-row-index branch; rotary
positions, grouped-query attention, the sliding window, the decoupled
`head_dim`, `use_bias`/`qkv_bias`, the per-head q/k RMSNorm `qk_norm`,
`attn_scale` and `attn_logit_cap`), `Mlp` (`act` 'gelu' (tanh), 'relu',
'swiglu', 'geglu'; `use_bias`), `TransformerBlock` and `Encoder`
(`window_pattern`, `remat`), with the options the GPT, BERT and ViT
configurations and the converted checkpoint families use: `causal`
(False by default, as in JAX; GPT passes True), an optional attention
`mask` (True = attend, broadcastable to [B, H, S, S]), `norm` 'layer' or
'rms', `norm_style` 'pre' (x + MHA(LN(x)); x + MLP(LN(x)), then a final
norm), 'post' (LN(x + MHA(x)); LN(x + MLP(x)), the original BERT
arrangement, no final norm), 'parallel' (one norm feeding attention and
MLP side by side: Phi, Falcon-7B), 'parallel2' (a parallel residual with
two norms: NeoX, Falcon-40B) and 'sandwich' (each sublayer normed on both
sides: Gemma-2), and `dropout_rate`: dropout on the attention output
after `out` and on the MLP output after `fc2`, in training only, drawn
from the `generator` the forward is given; the MoE fields (`MOE_FIELDS`,
`moe_every`): routed expert MLPs (`models/moe.py`) whose losses reach
the caller through a `losses` dict. Every other JAX field raises
NotImplementedError when set away from its default (`_UNPORTED`).

The dtype policy is the JAX one: parameters in fp32, matmuls in the
compute dtype (bf16 by default), the norms in fp32. Flax layouts map onto
torch ones in `models/flax_weights.py`: the DenseGeneral q/k/v kernels
[E, H, D] become Linear weights [H*D, E], `out` [H, D, E] becomes
[E, H*D], Dense [in, out] becomes Linear [out, in].

The KV cache is an explicit object (inference/decode.KVCache) passed down
the stack with the layer number, where flax keeps it in the "cache"
collection; its `index` is a Python int (one shared position — `generate`
and the admission prefill) or a [B] tensor (per-row positions — the
batcher's decode ticks). A paged cache (`decode.PagedKVCache`: pools and
a block table) takes the paged branch (`_paged_attention`), a rolling
cache (`decode.init_cache(..., rolling=True)`) the rolling branch on its
windowed layers (`_rolling_attention`). The JAX `rolling_cache` field of
`TransformerBlock` and `Encoder` (and of GPT) is accepted and has no
effect: the layers read the layout from the cache they are given.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts)

from tfde_tpu_torch.models.cnn import _init_flax_, dropout
from tfde_tpu_torch.ops import attention as attn_lib
from tfde_tpu_torch.ops.quant import kv_dequantize, kv_quantize
from tfde_tpu_torch.ops.rotary import apply_rotary

#: JAX `TransformerBlock`/`Encoder` fields outside the port, with the
#: default the port implements
_UNPORTED = {
    "fused_qkv": False,
    "quant": None,
    "paged_blocks": None,
    "kv_block": 16,
    "kv_quant": None,
}

#: the MoE fields of the JAX `TransformerBlock` (`Encoder` and `GPT` add
#: `moe_every`), with their defaults; `num_experts` > 0 makes the block's
#: MLP a `models.moe.MoEMlp`
MOE_FIELDS = {
    "num_experts": 0,
    "experts_per_token": 2,
    "moe_capacity_factor": 1.25,
    "moe_normalize_topk": True,
    "moe_shared_expert_dim": None,
    "router_z_loss_weight": 0.0,
}

#: the `MultiHeadAttention` fields `TransformerBlock` and `Encoder` pass
#: through (rope, grouped-query attention, the sliding window, the bias
#: and q/k-norm arrangements, the Gemma-2 score scale and softcap)
ATTN_FIELDS = ("rope", "rope_theta", "rope_scaling", "rope_dim",
               "num_kv_heads", "window", "qkv_bias", "qk_norm",
               "attn_scale", "attn_logit_cap")

#: the block arrangements (`TransformerBlock.forward`)
NORM_STYLES = ("pre", "post", "parallel", "parallel2", "sandwich")

#: the MLP activations (`Mlp`)
MLP_ACTS = ("gelu", "relu", "swiglu", "geglu")


def check_unported(owner: str, fields: dict, unported=None) -> None:
    """Raise for a JAX field of `owner` the port does not implement:
    TypeError for a name JAX does not have either, NotImplementedError for
    a value other than the default the port implements. `unported` maps
    each such field of `owner` to that default (`_UNPORTED` by default:
    the fields of the JAX `TransformerBlock` and `Encoder`)."""
    unported = _UNPORTED if unported is None else unported
    for name, value in fields.items():
        if name not in unported:
            raise TypeError(f"{owner} got an unexpected field {name!r}")
        if value != unported[name]:
            raise NotImplementedError(
                f"{owner} field {name}={value!r} is not ported yet (the "
                f"port implements {name}={unported[name]!r})")


def _check_norm_style(norm_style: str) -> None:
    if norm_style not in NORM_STYLES:
        raise ValueError(f"norm_style must be 'pre', 'post', 'parallel', "
                         f"'parallel2' or 'sandwich', got {norm_style!r}")


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
    (flax nn.LayerNorm(dtype=float32)). An fp64 model (a reference run)
    stays in fp64."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.promote_types(x.dtype, torch.float32))
        return F.layer_norm(x, self.normalized_shape, self.weight,
                            self.bias, self.eps)


class RMSNorm(nn.Module):
    """RMSNorm over the last dim, computed in fp32 whatever the input
    dtype and returned in fp32 (flax nn.RMSNorm(dtype=float32)): x *
    (rsqrt(mean(x^2) + eps) * scale), in flax's order. The scale is
    `weight` (flax `scale`) and is used as stored: a checkpoint whose norm
    computes x * (1 + w) (Gemma) is folded to 1 + w at conversion."""

    def __init__(self, dim: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.promote_types(x.dtype, torch.float32))
        ms = x.square().mean(dim=-1, keepdim=True)
        return x * (torch.rsqrt(ms + self.eps) * self.weight)


def make_norm(norm: str, dim: int, eps: float, device=None) -> nn.Module:
    """The block norm of kind `norm` ('layer' | 'rms')."""
    if norm not in ("layer", "rms"):
        raise ValueError(f"norm must be 'layer' or 'rms', got {norm!r}")
    cls = RMSNorm if norm == "rms" else LayerNorm
    return cls(dim, eps=eps, device=device)


@torch.no_grad()
def init_flax_(model: nn.Module, generator: torch.Generator) -> None:
    """flax's default initialisers on `model`'s layers: lecun_normal
    kernels for `Dense` and convolutions (`cnn._init_flax_`), normal(0,
    1 / sqrt(E)) embedding tables (flax `default_embed_init`), zero
    biases, unit LayerNorm scales, lecun_normal expert stacks
    (`MoEMlp.init_flax_`)."""
    from tfde_tpu_torch.models.moe import MoEMlp

    _init_flax_(model, generator, (Dense, nn.Linear, nn.Conv2d))
    for mod in model.modules():
        if isinstance(mod, MoEMlp):
            mod.init_flax_(generator)
        elif isinstance(mod, nn.Embedding):
            mod.weight.normal_(0.0, mod.weight.shape[1] ** -0.5,
                               generator=generator)
        elif isinstance(mod, LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, RMSNorm):
            mod.weight.fill_(1.0)


class MultiHeadAttention(nn.Module):
    """Self-attention with the dispatchable kernel (ops/attention.attention)
    and, when causal, the dense decode cache; dropout on its output.

    The projections go E -> H * head_dim (q) and Kv * head_dim (k, v),
    and `out` maps H * head_dim back to E: `head_dim` need not be E / H
    (Gemma, Qwen3). q/k/v carry a bias under `use_bias` or `qkv_bias`
    (Qwen2: biased q/k/v beside a bias-free `out`), `out` under
    `use_bias`. `qk_norm` (Qwen3) applies an fp32 RMSNorm over head_dim
    (`q_norm`, `k_norm`: one scale each, shared by the heads, epsilon
    `ln_eps`) to q and k after the projection and before rope, in the
    prefill and decode paths alike, so the cache holds the normed and
    rotated K. `rope` rotates q and k (ops/rotary.apply_rotary,
    `rope_theta`, `rope_scaling`, `rope_dim`) at their absolute positions
    before attention and before the cache write. `num_kv_heads`
    (grouped-query attention) makes `key`/`value` Kv * head_dim wide;
    query head h reads KV head h // (H / Kv), the layout of
    `grouped_attention` and of the kernels. `window` (causal only) lets
    position i attend positions (i - window, i]. `attn_scale` replaces the
    1 / sqrt(head_dim) score scale and `attn_logit_cap` softcaps the
    scaled scores (Gemma-2), in every attention call."""

    def __init__(self, embed: int, num_heads: int, head_dim: int,
                 dtype: torch.dtype, attn_impl: str = "auto",
                 causal: bool = False, dropout_rate: float = 0.0,
                 rope: bool = False, rope_theta: float = 10_000.0,
                 rope_scaling=None, rope_dim: Optional[int] = None,
                 num_kv_heads: Optional[int] = None,
                 window: Optional[int] = None, use_bias: bool = True,
                 qkv_bias: bool = False, qk_norm: bool = False,
                 ln_eps: float = 1e-6, attn_scale: Optional[float] = None,
                 attn_logit_cap: Optional[float] = None, device=None):
        super().__init__()
        kv_heads = num_kv_heads or num_heads
        if kv_heads <= 0 or num_heads % kv_heads:
            # (12 % -4 == 0 in Python: the sign check is needed)
            raise ValueError(f"num_kv_heads={kv_heads} must be positive and "
                             f"divide num_heads={num_heads}")
        if window is not None and not causal:
            raise ValueError(
                f"window={window} requires causal attention (the sliding "
                f"window is a band below the causal diagonal)")
        self.num_heads = num_heads
        self.kv_heads = kv_heads
        self.head_dim = head_dim
        self.dtype = dtype
        self.attn_impl = attn_impl
        self.causal = causal
        self.dropout_rate = dropout_rate
        self.rope = rope
        self.rope_theta = rope_theta
        self.rope_scaling = (None if rope_scaling is None
                             else tuple(rope_scaling))
        self.rope_dim = rope_dim
        self.window = window
        self.attn_scale = attn_scale
        self.attn_logit_cap = attn_logit_cap
        in_bias = use_bias or qkv_bias
        self.query = Dense(embed, num_heads * head_dim, dtype, bias=in_bias,
                           device=device)
        self.key = Dense(embed, kv_heads * head_dim, dtype, bias=in_bias,
                         device=device)
        self.value = Dense(embed, kv_heads * head_dim, dtype, bias=in_bias,
                           device=device)
        if qk_norm:
            self.q_norm = RMSNorm(head_dim, eps=ln_eps, device=device)
            self.k_norm = RMSNorm(head_dim, eps=ln_eps, device=device)
        else:
            self.q_norm = self.k_norm = None
        self.out = Dense(num_heads * head_dim, embed, dtype, bias=use_bias,
                         device=device)

    def forward(self, x: torch.Tensor, cache=None, layer: int = 0,
                mask: Optional[torch.Tensor] = None, train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        b, s, _ = x.shape
        q = self.query(x).view(b, s, self.num_heads, self.head_dim)
        k = self.key(x).view(b, s, self.kv_heads, self.head_dim)
        v = self.value(x).view(b, s, self.kv_heads, self.head_dim)
        if self.q_norm is not None:
            q = self.q_norm(q).to(self.dtype)
            k = self.k_norm(k).to(self.dtype)
        if cache is None:
            q, k = self._rotate(q, k, 0)
            y = attn_lib.attention(q, k, v, mask=mask, causal=self.causal,
                                   impl=self.attn_impl, window=self.window,
                                   scale=self.attn_scale,
                                   logit_cap=self.attn_logit_cap)
        else:
            if not self.causal:
                raise ValueError("decode requires causal attention")
            if mask is not None:
                raise NotImplementedError(
                    "decode builds its own cache-position mask; explicit "
                    "masks are not supported")
            y = self._decode_attention(q, k, v, cache, layer)
        y = self.out(y.reshape(b, s, -1))
        return dropout(y, self.dropout_rate, train, generator)

    def _rotate(self, q, k, start):
        """q and k rotated at positions start + [0, S): `start` an int
        (positions [S]) or a [B] tensor of per-row starts ([B, S]). A
        cached key keeps the rotation of its write, so each call rotates
        only its own tokens."""
        if not self.rope:
            return q, k
        pos = torch.arange(q.shape[1], device=q.device)
        pos = start + pos if isinstance(start, int) else start[:, None] + pos
        return tuple(apply_rotary(t, pos, self.rope_theta,
                                  rotary_dim=self.rope_dim,
                                  scaling=self.rope_scaling) for t in (q, k))

    def _decode_attention(self, q, k, v, cache, layer: int) -> torch.Tensor:
        """Rotate q/k at the cache positions, write this call's K/V into
        the [B, max_len, Kv, D] cache at `cache.index`, attend q over the
        filled prefix under the validity mask `j <= index + i` (and, with a
        window, `index + i - j < window`).

        The write is in place (the JAX program's dynamic_update_slice
        without the copy of the whole cache); like
        dynamic_update_slice, a start past `max_len - S` is clamped.

        A shared index of 0 is a prefill into a fresh row cache: columns
        past S are masked out, so the function is plain causal (windowed)
        self-attention over this call's own q/k/v — it goes through the
        dispatcher, and on a CUDA tensor to the flash kernel. Every other
        call (per-row decode ticks) is the masked einsum over the cache.
        A paged cache (one carrying a block `table`) takes
        `_paged_attention`.

        A full-precision cache stores `nan_to_num` of the K/V, as the
        paged cache does (JAX stores them as they are, and its speculative
        decoding at the position table's end emits NaN's argmax there).
        An int8 cache (`cache.quantized`) stores `kv_quantize` of this
        call's K/V (payload and scale planes at the same cells) and
        attends over `kv_dequantize` of the whole slab, as JAX does: the
        call's own tokens round-trip through the int8 format too, so the
        flash prefill at index 0 takes the dequantized K/V."""
        if getattr(cache, "table", None) is not None:
            return self._paged_attention(q, k, v, cache, layer)
        if cache.rolling and self.window is not None:
            return self._rolling_attention(q, k, v, cache, layer)
        quant = cache.quantized
        planes = [cache.keys[layer], cache.values[layer]]
        if quant:
            planes += [cache.key_scales[layer], cache.value_scales[layer]]
        sq = q.shape[1]
        max_len = planes[0].shape[1]
        if sq > max_len:
            raise ValueError(
                f"input length {sq} exceeds the cache budget {max_len}; "
                f"re-init the cache with a larger max_len")
        idx = cache.index
        q, k = self._rotate(q, k, idx)
        if quant:
            (k_q, k_s), (v_q, v_s) = kv_quantize(k), kv_quantize(v)
            writes = [k_q, v_q, k_s, v_s]
            k_w = kv_dequantize(k_q, k_s, k.dtype)
            v_w = kv_dequantize(v_q, v_s, v.dtype)
        else:
            # nan_to_num (the identity on finite values): a learned
            # position past the table embeds NaN, and speculative rounds
            # feed up to num_draft positions past a row's budget; a masked
            # cell's zero weight would still take 0 * NaN
            k_w = torch.nan_to_num(k.to(planes[0].dtype))
            v_w = torch.nan_to_num(v.to(planes[1].dtype))
            writes = [k_w, v_w]
        cols = torch.arange(max_len, device=q.device)
        steps = torch.arange(sq, device=q.device)
        opts = dict(scale=self.attn_scale, logit_cap=self.attn_logit_cap)
        if isinstance(idx, int):
            start = min(max(idx, 0), max_len - sq)
            for plane, new in zip(planes, writes):
                plane[:, start:start + sq] = new
            if idx == 0:
                return attn_lib.attention(q, k_w, v_w, causal=True,
                                          impl=self.attn_impl,
                                          window=self.window, **opts)
            pos = (idx + steps)[None]  # [1, sq]
        else:
            start = idx.clamp(0, max_len - sq)
            rows = torch.arange(q.shape[0], device=q.device)[:, None]
            for plane, new in zip(planes, writes):
                plane[rows, start[:, None] + steps] = new
            pos = idx[:, None] + steps  # [B, sq]
        ago = pos[:, :, None] - cols  # [B | 1, sq, max_len]
        valid = ago >= 0
        if self.window is not None:
            valid = valid & (ago < self.window)
        keys, values = planes[:2]
        if quant:
            keys = kv_dequantize(keys, planes[2], k.dtype)
            values = kv_dequantize(values, planes[3], v.dtype)
        return attn_lib.grouped_attention(q, keys, values,
                                          mask=valid[:, None], **opts)

    def _rolling_attention(self, q, k, v, cache, layer: int) -> torch.Tensor:
        """The window-bounded rolling cache (JAX `_rolling_attention`): the
        token at position p lives in slot p mod Wc of the layer's [B, Wc,
        Kv, D] planes (Wc = min(budget, window)), so decode memory is
        O(window). After this call's writes the newest position is P =
        index + S - 1, and slot j holds position b_j = P - ((P - j) mod
        Wc); a query at position p attends slot j iff 0 <= b_j <= p and
        p - b_j < window (the masked einsum over the slots).

        The index must be an int: a per-row [B] index raises
        NotImplementedError, as in JAX (the per-row paths rewind and keep
        the full cache). One prefill from position 0, then single-token
        steps: a prefill at index 0 is plain causal windowed attention
        over the call's own q/k/v and goes through the dispatcher (the
        flash kernel on a CUDA tensor), and so does a prompt longer than
        the cache (S > Wc; only at index 0, where every key a band-limited
        query needs is in the call), which keeps its newest Wc tokens."""
        keys, values = cache.keys[layer], cache.values[layer]
        sq, wc = q.shape[1], keys.shape[1]
        idx = cache.index
        if not isinstance(idx, int):
            if sq > wc:
                raise ValueError(
                    "per-row prefill longer than the rolling window cache "
                    "is unsupported (rows would need in-batch keys beyond "
                    "their own cache)")
            raise NotImplementedError(
                "rolling_cache with per-row cache indices is unsupported — "
                "the per-row paths (speculative decoding, row-recycling "
                "servers) use the full-budget cache")
        if sq > wc and idx != 0:
            raise ValueError(
                f"a {sq}-token call at position {idx} overflows the "
                f"{wc}-slot rolling cache: a call longer than the window "
                f"is a prefill from position 0")
        q, k = self._rotate(q, k, idx)
        k_w, v_w = k.to(keys.dtype), v.to(values.dtype)
        opts = dict(scale=self.attn_scale, logit_cap=self.attn_logit_cap)
        pos = idx + torch.arange(sq, device=q.device)
        if sq > wc:
            keys[:, pos[-wc:] % wc] = k_w[:, -wc:]
            values[:, pos[-wc:] % wc] = v_w[:, -wc:]
        else:
            keys[:, pos % wc] = k_w
            values[:, pos % wc] = v_w
        if idx == 0:
            return attn_lib.attention(q, k_w, v_w, causal=True,
                                      impl=self.attn_impl, window=self.window,
                                      **opts)
        last = idx + sq - 1
        held = last - ((last - torch.arange(wc, device=q.device)) % wc)
        ago = pos[:, None] - held[None, :]  # [sq, Wc]
        valid = (held >= 0) & (ago >= 0) & (ago < self.window)
        return attn_lib.grouped_attention(q, keys, values,
                                          mask=valid[None, None], **opts)

    def _paged_attention(self, q, k, v, cache, layer: int) -> torch.Tensor:
        """Paged decode attention (JAX `_paged_attention`): write this
        call's K/V into the layer's pool [num_blocks, block, Kv, D] at
        (table[r, pos // block], pos % block), gather each row's table
        back into position order ([B, nmax*block, Kv, D]: column j IS
        position j) and attend under the dense mask `j <= index + i` (and
        the window) with the masked einsum. `cache.index` is an int or a
        [B] tensor.

        Writes past the table go to the null block 0, and the written K/V
        pass through nan_to_num (the identity on finite values): a row
        pad-fed past its committed count can carry non-finite activations
        (a learned position past the table embeds NaN), and a masked
        column's zero weight would still take 0 * NaN. Duplicate writes
        land only in block 0, which no mask reads, so their order does
        not matter; shared trie blocks are never written (the trie holds
        complete prompt blocks and a warm row writes from its
        block-aligned prefix length on). An int8 cache writes
        `kv_quantize` of the K/V (which zeroes non-finite values itself)
        into the payload and scale pools at the same cells and gathers
        both through the table into `kv_dequantize`."""
        pool_k, pool_v = cache.keys[layer], cache.values[layer]
        block, table = cache.block, cache.table
        b, sq = q.shape[:2]
        nmax = table.shape[1]
        idx = cache.index
        q, k = self._rotate(q, k, idx)
        steps = torch.arange(sq, device=q.device)
        if isinstance(idx, int):
            pos = (idx + steps)[None].expand(b, sq)
        else:
            pos = idx[:, None] + steps  # [B, sq]
        slot = pos // block
        rows = torch.arange(b, device=q.device)[:, None]
        blk = torch.where(slot < nmax, table[rows, slot.clamp(0, nmax - 1)],
                          torch.zeros_like(slot))
        off = pos % block
        if cache.quantized:
            pool_ks = cache.key_scales[layer]
            pool_vs = cache.value_scales[layer]
            (k_q, k_s), (v_q, v_s) = kv_quantize(k), kv_quantize(v)
            pool_k[blk, off], pool_ks[blk, off] = k_q, k_s
            pool_v[blk, off], pool_vs[blk, off] = v_q, v_s
            k_all = kv_dequantize(pool_k[table], pool_ks[table], k.dtype)
            v_all = kv_dequantize(pool_v[table], pool_vs[table], v.dtype)
        else:
            pool_k[blk, off] = torch.nan_to_num(k.to(pool_k.dtype))
            pool_v[blk, off] = torch.nan_to_num(v.to(pool_v.dtype))
            k_all, v_all = pool_k[table], pool_v[table]
        k_all = k_all.reshape(b, nmax * block, *pool_k.shape[2:])
        v_all = v_all.reshape(b, nmax * block, *pool_v.shape[2:])
        cols = torch.arange(nmax * block, device=q.device)
        ago = pos[:, :, None] - cols  # [B, sq, nmax*block]
        valid = ago >= 0
        if self.window is not None:
            valid = valid & (ago < self.window)
        return attn_lib.grouped_attention(
            q, k_all, v_all, mask=valid[:, None], scale=self.attn_scale,
            logit_cap=self.attn_logit_cap)


class Mlp(nn.Module):
    """fc1 -> act -> fc2, then dropout. `act`: 'gelu' (the tanh
    approximation, flax nn.gelu's default), 'relu' (OPT), 'swiglu'
    (silu(gate(x)) * fc1(x): the LLaMA family) or 'geglu' (tanh-gelu on
    the gate: Gemma). Every projection carries a bias under `use_bias`."""

    def __init__(self, embed: int, mlp_dim: int, dtype: torch.dtype,
                 dropout_rate: float = 0.0, act: str = "gelu",
                 use_bias: bool = True, device=None):
        super().__init__()
        if act not in MLP_ACTS:
            raise ValueError(f"act must be 'gelu', 'relu', 'swiglu' or "
                             f"'geglu', got {act!r}")
        self.dropout_rate = dropout_rate
        self.act = act
        self.fc1 = Dense(embed, mlp_dim, dtype, bias=use_bias, device=device)
        self.gate = (Dense(embed, mlp_dim, dtype, bias=use_bias,
                           device=device)
                     if act in ("swiglu", "geglu") else None)
        self.fc2 = Dense(mlp_dim, embed, dtype, bias=use_bias, device=device)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        h = self.fc1(x)
        if self.act == "gelu":
            h = F.gelu(h, approximate="tanh")
        elif self.act == "relu":
            h = F.relu(h)
        elif self.act == "swiglu":
            h = F.silu(self.gate(x)) * h
        else:
            h = F.gelu(self.gate(x), approximate="tanh") * h
        return dropout(self.fc2(h), self.dropout_rate, train, generator)


class TransformerBlock(nn.Module):
    """One block in the arrangement `norm_style` (JAX :822-850), each norm
    (`norm`: LayerNorm or RMSNorm, fp32) cast back to the compute dtype:

    - 'pre': x + MHA(ln_attn(x)); x + MLP(ln_mlp(x));
    - 'post': ln_attn(x + MHA(x)); ln_mlp(x + MLP(x)) (the original BERT);
    - 'parallel': x + MHA(y) + MLP(y), y = ln_attn(x) (one norm: Phi);
    - 'parallel2': x + MHA(ln_attn(x)) + MLP(ln_mlp(x)) (NeoX);
    - 'sandwich': x + ln_attn_post(MHA(ln_attn(x))); then x +
      ln_mlp_post(MLP(ln_mlp(x))) (Gemma-2).

    The attention fields (`ATTN_FIELDS`) go to `MultiHeadAttention`,
    `mlp_act` and `use_bias` to `Mlp` (and `use_bias` to the attention).
    With `num_experts` > 0 (`MOE_FIELDS`) the MLP is a routed
    `models.moe.MoEMlp` named `moe` (gelu + bias or bias-free swiglu
    experts, as JAX refuses other arrangements); its losses go into the
    `losses` dict the forward is given."""

    def __init__(self, embed: int, num_heads: int, head_dim: int,
                 mlp_dim: int, dtype: torch.dtype, attn_impl: str = "auto",
                 ln_eps: float = 1e-6, causal: bool = False,
                 norm_style: str = "pre", norm: str = "layer",
                 mlp_act: str = "gelu", use_bias: bool = True,
                 dropout_rate: float = 0.0, rolling_cache: bool = False,
                 device=None, **fields):
        super().__init__()
        attn_fields = {k: fields.pop(k) for k in ATTN_FIELDS if k in fields}
        moe = {k: fields.pop(k, v) for k, v in MOE_FIELDS.items()}
        if moe["num_experts"] > 0 and (mlp_act, use_bias) not in (
                ("gelu", True), ("swiglu", False)):
            raise NotImplementedError(
                "MoE expert MLPs are gelu+bias (Switch/GShard) or "
                "bias-free swiglu (Mixtral); other mlp_act/use_bias "
                "combinations would silently build a different "
                "architecture than requested")
        check_unported("TransformerBlock", fields)
        _check_norm_style(norm_style)
        self.dtype = dtype
        self.norm_style = norm_style

        def ln():
            return make_norm(norm, embed, ln_eps, device)

        self.ln_attn = ln()
        self.attn = MultiHeadAttention(embed, num_heads, head_dim, dtype,
                                       attn_impl=attn_impl, causal=causal,
                                       dropout_rate=dropout_rate,
                                       use_bias=use_bias, ln_eps=ln_eps,
                                       device=device, **attn_fields)
        self.ln_mlp = None if norm_style == "parallel" else ln()
        if moe["num_experts"] > 0:
            from tfde_tpu_torch.models.moe import MoEMlp

            self.mlp = None
            self.moe = MoEMlp(
                embed, moe["num_experts"], mlp_dim,
                experts_per_token=moe["experts_per_token"],
                capacity_factor=moe["moe_capacity_factor"],
                normalize_topk=moe["moe_normalize_topk"],
                shared_expert_dim=moe["moe_shared_expert_dim"],
                act=mlp_act, use_bias=use_bias,
                router_z_loss_weight=moe["router_z_loss_weight"],
                dropout_rate=dropout_rate, dtype=dtype, device=device)
        else:
            self.moe = None
            self.mlp = Mlp(embed, mlp_dim, dtype, dropout_rate=dropout_rate,
                           act=mlp_act, use_bias=use_bias, device=device)
        if norm_style == "sandwich":
            self.ln_attn_post, self.ln_mlp_post = ln(), ln()

    def forward(self, x: torch.Tensor, cache=None, layer: int = 0,
                mask: Optional[torch.Tensor] = None, train: bool = False,
                generator: Optional[torch.Generator] = None,
                losses: Optional[dict] = None) -> torch.Tensor:
        def attn(y):
            return self.attn(y, cache, layer, mask, train, generator)

        def mlp(y):
            if self.moe is not None:
                return self.moe(y, train, generator, losses)
            return self.mlp(y, train, generator)

        def norm(ln, y):
            return ln(y).to(self.dtype)

        style = self.norm_style
        if style == "post":
            x = norm(self.ln_attn, x + attn(x))
            return norm(self.ln_mlp, x + mlp(x))
        if style == "parallel":
            y = norm(self.ln_attn, x)
            return x + attn(y) + mlp(y)
        if style == "parallel2":
            return (x + attn(norm(self.ln_attn, x))
                    + mlp(norm(self.ln_mlp, x)))
        if style == "sandwich":
            x = x + norm(self.ln_attn_post, attn(norm(self.ln_attn, x)))
            return x + norm(self.ln_mlp_post, mlp(norm(self.ln_mlp, x)))
        x = x + attn(norm(self.ln_attn, x))
        return x + mlp(norm(self.ln_mlp, x))


#: the GEMMs without batch dims (a `Dense` on [B, S, E] folds to one of
#: these); under remat='dots' their outputs are saved and every other op
#: is recomputed, attention included (jax.checkpoint_policies.
#: dots_with_no_batch_dims_saveable: the Pallas kernel is no dot)
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat_mode(remat):
    """None (no remat), 'full' (recompute the whole block in the backward)
    or 'dots' (save the outputs of the GEMMs without batch dims, recompute
    the rest) for the JAX `remat` values False | True/'full' | 'dots'."""
    if not remat:
        return None
    if remat is True or remat == "full":
        return "full"
    if remat == "dots":
        return "dots"
    raise ValueError(
        f"remat must be False, True, 'full', or 'dots'; got {remat!r}")


class Encoder(nn.Module):
    """`depth` blocks (`block_0` ...) and, unless the blocks are post-LN,
    the final fp32 norm `ln_final` of kind `norm` (post-LN blocks already
    end normalised, and the JAX post-LN Encoder has none).

    `window` reaches every block (`window_pattern='all'`) or the even ones
    (`'alternate'`: the odd blocks attend in full, the Gemma-2
    interleave). `remat` (`remat_mode`) checkpoints each block in training
    with `torch.utils.checkpoint` (non-reentrant); decode refuses it.

    With `num_experts` > 0 block i is an MoE block when i % `moe_every` ==
    `moe_every` - 1 (every other block by default, the GShard
    convention). A forward given a `losses` dict collects every MoE
    block's losses in it (`models.moe`), under remat too: a checkpointed
    block returns them beside its output."""

    def __init__(self, depth: int, embed: int, num_heads: int,
                 head_dim: int, mlp_dim: int, dtype: torch.dtype,
                 attn_impl: str = "auto", ln_eps: float = 1e-6,
                 causal: bool = False, norm_style: str = "pre",
                 norm: str = "layer", mlp_act: str = "gelu",
                 use_bias: bool = True, dropout_rate: float = 0.0,
                 window: Optional[int] = None, window_pattern: str = "all",
                 remat=False, rolling_cache: bool = False,
                 moe_every: int = 2, device=None, **fields):
        super().__init__()
        attn_fields = {k: fields.pop(k) for k in ATTN_FIELDS if k in fields}
        moe = {k: fields.pop(k) for k in MOE_FIELDS if k in fields}
        experts = moe.pop("num_experts", 0)
        check_unported("Encoder", fields)
        _check_norm_style(norm_style)
        if window_pattern not in ("all", "alternate"):
            raise ValueError(f"window_pattern must be 'all' or 'alternate', "
                             f"got {window_pattern!r}")
        self.depth = depth
        self.dropout_rate = dropout_rate
        self.remat = remat_mode(remat)
        for i in range(depth):
            windowed = window_pattern == "all" or i % 2 == 0
            is_moe = experts > 0 and i % moe_every == moe_every - 1
            block_moe = dict(moe, num_experts=experts) if is_moe else {}
            self.add_module(f"block_{i}", TransformerBlock(
                embed, num_heads, head_dim, mlp_dim, dtype,
                attn_impl=attn_impl, ln_eps=ln_eps, causal=causal,
                norm_style=norm_style, norm=norm, mlp_act=mlp_act,
                use_bias=use_bias, dropout_rate=dropout_rate,
                window=window if windowed else None, device=device,
                **attn_fields, **block_moe))
        self.ln_final = (None if norm_style == "post"
                         else make_norm(norm, embed, ln_eps, device))

    def blocks(self):
        return [getattr(self, f"block_{i}") for i in range(self.depth)]

    def forward(self, x: torch.Tensor, cache=None,
                mask: Optional[torch.Tensor] = None, train: bool = False,
                generator: Optional[torch.Generator] = None,
                losses: Optional[dict] = None) -> torch.Tensor:
        if cache is not None and self.remat is not None:
            raise ValueError(
                "decode does not compose with remat: there is no backward "
                "to recompute for (inference/decode.remat_off serves a "
                "remat-trained model)")
        for i, block in enumerate(self.blocks()):
            if self.remat is not None and torch.is_grad_enabled():
                x = self._checkpointed(block, x, mask, train, generator,
                                       losses)
            else:
                x = block(x, cache, i, mask, train, generator, losses)
        return x if self.ln_final is None else self.ln_final(x)

    def _checkpointed(self, block, x, mask, train, generator, losses=None):
        """`block` under `torch.utils.checkpoint`: its activations are
        recomputed in the backward. Dropout draws from `generator`, whose
        state checkpoint's `preserve_rng_state` (torch's default
        generators only) does not restore: with dropout on, the block runs
        on a private generator that starts from `generator`'s state in the
        forward and again in the recompute, so both draw the same masks,
        and `generator` then moves on to where the forward left it, as if
        the block had drawn from it. The model draws from no default
        generator, so checkpoint preserves none. An MoE block's losses
        (when `losses` is given) are returned beside its output, so the
        recompute appends to a dict of its own and not to `losses`."""
        kw = dict(use_reentrant=False, preserve_rng_state=False)
        if self.remat == "dots":
            kw["context_fn"] = functools.partial(
                create_selective_checkpoint_contexts, _dots_policy)
        names = []
        sow = losses is not None and block.moe is not None

        def body(h, g):
            if not sow:
                return block(h, None, 0, mask, train, g)
            sown = {}
            out = block(h, None, 0, mask, train, g, sown)
            names[:] = [(name, len(vals)) for name, vals in sown.items()]
            return (out, *(t for vals in sown.values() for t in vals))

        if not (train and self.dropout_rate > 0 and generator is not None):
            out = checkpoint(body, x, generator, **kw)
        else:
            start, end = generator.get_state(), []

            def run(h):
                g = torch.Generator(device=generator.device)
                g.set_state(start)
                out = body(h, g)
                end.append(g.get_state())
                return out

            out = checkpoint(run, x, **kw)
            generator.set_state(end[0])
        if not sow:
            return out
        out, *flat = out
        for name, count in names:
            losses.setdefault(name, []).extend(flat[:count])
            flat = flat[count:]
        return out
