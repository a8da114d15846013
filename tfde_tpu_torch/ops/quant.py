"""Int8 KV-cache quantization — counterpart of `kv_quantize` and
`kv_dequantize` in `tfde_tpu/ops/quant.py`.

One fp32 scale per (position, kv-head): absmax over the trailing head-dim
vector, the finest grain that still writes one scale cell a cached token.
The int8 payload and the scale planes are what the serving caches hold
(`inference/decode.init_cache(..., kv_quant='int8')`); attention reads
them back through `kv_dequantize`.

Bit-equal to the JAX functions on the same fp32 input: the scale is
`max(amax, 1e-12) / 127` (a division, as in JAX), the payload
`round(x / scale)` with ties to even (`torch.round`, like `jnp.round`),
clipped to +-127. Weight-only int8 (`QuantDenseGeneral`, `QuantEmbed`,
`quantize_params`) is not ported yet (ROADMAP queue 1 item 6).
"""

from __future__ import annotations

from typing import Tuple

import torch


def kv_quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q int8 [x.shape], scale fp32 [x.shape[:-1]]) with x ~= q * scale.

    Non-finite inputs are zeroed first: a rider row pad-fed past its
    committed count can carry NaN or inf, and one inf would blow its
    vector's scale while a NaN would reach the attention output through
    0 * NaN. Zeroing is the identity on finite values."""
    xf = torch.nan_to_num(x.float(), nan=0.0, posinf=0.0, neginf=0.0)
    scale = xf.abs().amax(dim=-1).clamp_min(1e-12) / 127.0
    q = torch.round(xf / scale[..., None]).clamp_(-127, 127).to(torch.int8)
    return q, scale


def kv_dequantize(q: torch.Tensor, scale: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    """`q * scale` over the trailing head dim, cast to `dtype` (the
    attention's compute dtype)."""
    return (q.float() * scale[..., None]).to(dtype)
