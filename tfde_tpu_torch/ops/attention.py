"""Attention ops — counterpart of `tfde_tpu/ops/attention.py`.

Two implementations behind one dispatcher:

- ``reference``: the masked fp32-softmax einsum (`grouped_attention`),
  the numerics oracle and the decode path's attention over the cache.
  Scores accumulate in fp32 from the inputs' values, the softmax runs in
  fp32, the weights are cast to v's dtype before the second product — the
  JAX package's `preferred_element_type=float32` arithmetic.
- ``flash``: the hand-written CUDA forward (ops/flash_attention.py) on a
  CUDA tensor, its plain version on a CPU tensor.

``auto`` picks flash for unmasked causal attention on a CUDA tensor, and
the reference einsum otherwise; the kernel's wrapper owns every shape and
dtype check and raises on what it does not take, so a CUDA tensor never
falls back to the plain version. The TPU's thresholds (flash only from S >= 2048) do not carry over: they were
measured on a v5e, and on the H100 the kernel is the path that keeps the
[S, S] score matrix out of device memory at every length.

Shapes follow the JAX package: q/k/v are [batch, length, heads, head_dim].
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from tfde_tpu_torch.ops import flash_attention as fa


def reference_attention(q, k, v, mask=None, causal: bool = False,
                        window: Optional[int] = None,
                        scale: Optional[float] = None,
                        logit_cap: Optional[float] = None) -> torch.Tensor:
    """Plain softmax(QK^T/sqrt(d))V: the groups == 1 case of
    `grouped_attention` (one implementation for the oracle and the GQA
    decode path)."""
    return grouped_attention(q, k, v, mask=mask, causal=causal,
                             window=window, scale=scale, logit_cap=logit_cap)


def grouped_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mask: Optional[torch.Tensor] = None,
                      causal: bool = False, window: Optional[int] = None,
                      scale: Optional[float] = None,
                      logit_cap: Optional[float] = None) -> torch.Tensor:
    """q [B,Sq,H,D] against k/v [B,Sk,Kv,D], H = Kv * groups.

    mask: broadcastable to [B, H, Sq, Sk] (or with a size-1 head dim),
    True = attend. causal aligns the rows with the LAST Sq positions.
    scale defaults to 1/sqrt(d) in fp32; logit_cap softcaps after the scale
    and before the mask. Masked logits take float32's min, so their
    weights are exactly zero."""
    b, sq, h, d = q.shape
    kv = k.shape[2]
    if h % kv:
        raise ValueError(
            f"query heads {h} must be a multiple of kv heads {kv}")
    if window is not None and (not causal or window < 1):
        raise ValueError(
            f"window={window} requires causal=True and window >= 1 — the "
            f"sliding window is a band below the causal diagonal")
    if logit_cap is not None and logit_cap <= 0:
        raise ValueError(f"logit_cap={logit_cap} must be > 0")
    g = h // kv
    sk = k.shape[1]
    if scale is None:
        # 1/sqrt(d) computed in float32, as the JAX reference computes it
        scale = float(np.float32(1.0) / np.sqrt(np.float32(d)))
    qg = q.reshape(b, sq, kv, g, d)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) * scale
    if logit_cap is not None:
        logits = logit_cap * torch.tanh(logits / logit_cap)
    if causal:
        cm = torch.ones((sq, sk), dtype=torch.bool, device=q.device).tril(
            diagonal=sk - sq)
        if window is not None:
            rows = (sk - sq) + torch.arange(sq, device=q.device)[:, None]
            cols = torch.arange(sk, device=q.device)[None, :]
            cm = cm & (rows - cols < window)
        mask = cm if mask is None else (mask & cm)
    if mask is not None:
        if mask.dim() == 2:  # [Sq, Sk]
            mask = mask[None, None, None]
        elif mask.dim() == 3:  # [B|1, Sq, Sk]
            mask = mask[:, None, None]
        elif mask.dim() == 4:  # [B|1, H|1, Sq, Sk]
            if mask.shape[1] == h:
                mask = mask.reshape(mask.shape[0], kv, g, *mask.shape[2:])
            else:
                mask = mask[:, :, None]
        else:
            raise ValueError(
                f"mask must be broadcastable to [B,H,Sq,Sk] (ndim 2/3/4), "
                f"got ndim={mask.dim()}")
        logits = logits.masked_fill(~mask, torch.finfo(torch.float32).min)
    weights = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", weights.to(v.dtype).float(),
                       v.float())
    return out.reshape(b, sq, h, d).to(q.dtype)


def _flash_eligible(q, mask, causal) -> bool:
    return q.device.type == "cuda" and causal and mask is None


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              mask: Optional[torch.Tensor] = None, causal: bool = False,
              impl: str = "auto", window: Optional[int] = None,
              scale: Optional[float] = None,
              logit_cap: Optional[float] = None) -> torch.Tensor:
    """Dispatching attention: [B,S,H,D] -> [B,S,H,D].

    impl: 'auto' | 'reference' | 'flash'. 'auto' takes flash for unmasked
    causal attention on a CUDA tensor, else the reference einsum; flash
    raises on shapes the kernel does not take (cross-attention, a head dim
    other than 64 or 128). 'ring' (sequence parallelism) is not ported
    yet."""
    if impl == "auto":
        impl = "flash" if _flash_eligible(q, mask, causal) else "reference"
    if impl == "reference":
        return reference_attention(q, k, v, mask=mask, causal=causal,
                                   window=window, scale=scale,
                                   logit_cap=logit_cap)
    if impl == "flash":
        if mask is not None:
            raise NotImplementedError(
                "flash attention does not take an explicit mask; use "
                "impl='reference' (or 'auto', which refuses flash when a "
                "mask is present)")
        return fa.flash_attention(q, k, v, causal=causal, window=window,
                                  scale=scale, logit_cap=logit_cap)
    if impl == "ring":
        raise NotImplementedError(
            "attn_impl='ring' (sequence-parallel ring attention) is not "
            "ported yet")
    raise ValueError(f"unknown attention impl {impl!r}")


def padding_mask(valid: torch.Tensor) -> torch.Tensor:
    """[B, S] 1/True-for-real-token -> [B, 1, 1, S] attention mask."""
    return valid.to(torch.bool)[:, None, None, :]
