"""Flash attention forward — a hand-written CUDA kernel for Hopper.

Counterpart of `tfde_tpu/ops/flash_attention.py`. The Pallas forward
(`_fwd_kernel`, launched by `_flash_forward`) becomes
`csrc/flash_fwd.cu`, built with nvcc for sm_90a into a plain C library and
bound with ctypes (`utils/build.py`). `flash_forward` dispatches on the
tensor it is given: a CUDA tensor launches the kernel (or raises), a CPU
tensor takes `flash_forward_reference`, the plain PyTorch version of the
same function — which is also what `chip_smoke.py` holds the kernel
against on the card.

The band helpers (`_tile_in_band`, `_band_tile_pairs`, `bwd_tile_plan`)
are the JAX package's, as pure Python: the kernel's K-tile loop bounds
are the same predicate, and the backward slice will scan the same pairs.

Only the forward is ported; the backward pair (`_dkv_kernel`,
`_dq_kernel`) comes with the training slice.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from tfde_tpu_torch.utils.build import build_library

_NEG = -1e30

#: head dims the kernel is compiled for
KERNEL_HEAD_DIMS = (64, 128)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _auto_block(s: int) -> int:
    """The JAX package's default tile edge: the largest of 512/256/128 that
    divides S, else min(S, 128). Kept for `bwd_tile_plan` parity; the
    CUDA kernel's own tiles are 64 x 64 (csrc/flash_fwd.cu BM, BN)."""
    for bl in (512, 256, 128):
        if s % bl == 0:
            return bl
    return min(s, 128)


def _resolve_block(block, s: int) -> int:
    return _auto_block(s) if block is None else min(block, s)


def _tile_in_band(qi, kb, block_q: int, block_k: int, causal, window):
    """Whether tile (qi, kb) holds any unmasked (row, col) pair: its first
    column is not past the Q tile's last row and, with a sliding window,
    its last column is not older than the oldest position the Q tile's
    first row can see. The CUDA kernel's K loop runs exactly over the
    tiles this accepts."""
    if not causal:
        return True
    live = kb * block_k <= (qi + 1) * block_q - 1
    if window is not None:
        live = (kb * block_k + block_k - 1 >= qi * block_q - (window - 1)) \
            & live
    return live


def _band_tile_pairs(s: int, block_q: int, block_k: int, causal: bool,
                     window) -> list:
    """The in-band (qi, kb) tile pairs of an S x S attention."""
    n_q, n_k = s // block_q, s // block_k
    return [
        (qi, kb)
        for qi in range(n_q)
        for kb in range(n_k)
        if bool(_tile_in_band(qi, kb, block_q, block_k, causal, window))
    ]


def bwd_tile_plan(s: int, block_q=None, block_k=None, causal: bool = True,
                  window=None) -> dict:
    """Resolved tile sizes, full grid size and the in-band pairs, as the
    JAX package's `bwd_tile_plan` reports them."""
    bq = _resolve_block(block_q, s)
    bk = _resolve_block(block_k, s)
    pairs = _band_tile_pairs(s, bq, bk, causal, window)
    n_q, n_k = s // bq, s // bk
    per_q = [0] * n_q
    per_k = [0] * n_k
    for qi, kb in pairs:
        per_q[qi] += 1
        per_k[kb] += 1
    return {
        "block_q": bq,
        "block_k": bk,
        "grid": n_q * n_k,
        "visits": len(pairs),
        "pairs": pairs,
        "max_visits_per_q_tile": max(per_q) if per_q else 0,
        "max_visits_per_k_tile": max(per_k) if per_k else 0,
    }


def _check_args(q, k, v, causal, window, logit_cap) -> None:
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q/k/v must be [B, S, H, D]; got q {tuple(q.shape)}")
    b, s, h, d = q.shape
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} "
                         f"must match")
    kv = k.shape[2]
    if k.shape[0] != b or k.shape[1] != s or k.shape[3] != d:
        raise ValueError(
            f"flash attention requires self-attention shapes: q "
            f"{tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}; use "
            f"impl='reference' for cross-attention (Sk != Sq)")
    if h % kv:
        raise ValueError(
            f"query heads {h} must be a multiple of kv heads {kv} (GQA)")
    if window is not None and (not causal or window < 1):
        raise ValueError(
            f"window={window} requires causal=True and window >= 1")
    if logit_cap is not None and logit_cap <= 0:
        raise ValueError(f"logit_cap={logit_cap} must be positive")


def flash_forward_reference(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, causal: bool = False,
                            window: Optional[int] = None,
                            scale: Optional[float] = None,
                            logit_cap: Optional[float] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the kernel: the whole [S, S] score
    matrix in fp32, masked with -1e30 after the cap, softmax, then P V.
    Returns (out [B, S, H, D] in q's dtype, lse [B, H, S] fp32)."""
    _check_args(q, k, v, causal, window, logit_cap)
    b, s, h, d = q.shape
    g = h // k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    kf = k.float().repeat_interleave(g, dim=2)
    vf = v.float().repeat_interleave(g, dim=2)
    z = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * scale
    if logit_cap is not None:
        z = logit_cap * torch.tanh(z / logit_cap)
    if causal:
        rows = torch.arange(s, device=q.device)[:, None]
        cols = torch.arange(s, device=q.device)[None, :]
        keep = rows >= cols
        if window is not None:
            keep = keep & (rows - cols < window)
        z = z.masked_fill(~keep, _NEG)
    m = z.amax(dim=-1, keepdim=True)
    p = torch.exp(z - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-20)
    out = torch.einsum("bhqk,bkhd->bqhd", p, vf) / l.permute(0, 2, 1, 3)
    lse = (m + torch.log(l))[..., 0]
    return out.to(q.dtype), lse


#: ctypes signature of `tfde_flash_fwd` in csrc/flash_fwd.cu: q, k, v, out,
#: lse pointers; B, S, H, KV, D; the B/S/H element strides of q, k, v and
#: out; causal, window, scale, logit_cap, dtype; the CUDA stream
ARGTYPES = ((ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 5
            + (ctypes.c_longlong,) * 12
            + (ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
               ctypes.c_int, ctypes.c_void_p))

_LIB = None


def build(force: bool = False):
    """Compile (or reuse) `csrc/flash_fwd.cu` and bind its C entry point.
    Returns the `utils.build.KernelLibrary`; raises if nvcc or the load
    fails."""
    global _LIB
    if _LIB is None or force:
        lib = build_library("flash_fwd.cu", force=force)
        fn = lib.lib.tfde_flash_fwd
        fn.argtypes = list(ARGTYPES)
        fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _launch(q, k, v, causal, window, scale, logit_cap):
    b, s, h, d = q.shape
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(
            f"the CUDA flash kernel takes head_dim {KERNEL_HEAD_DIMS}, got {d}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"the CUDA flash kernel takes float32 or bfloat16 q/k/v of one "
            f"dtype; got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (k.device == q.device and v.device == q.device):
        raise ValueError("q, k and v must lie on one CUDA device")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("the CUDA flash kernel needs a contiguous head dim")
    if q.dtype == torch.bfloat16 and any(
            t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:3])
            for t in (q, k, v)):
        raise ValueError("the bf16 CUDA flash kernel reads 16-byte vectors: "
                         "q/k/v need 16-byte aligned rows")
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    fn = build().lib.tfde_flash_fwd
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr(), b, s, h, k.shape[2], d,
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 *out.stride()[:3], int(causal),
                 0 if window is None else int(window), float(scale),
                 0.0 if logit_cap is None else float(logit_cap),
                 _DTYPES[q.dtype], stream)
    if err:
        raise RuntimeError(f"flash_fwd launch failed: cudaError_t {err}")
    flash_forward.launches += 1
    return out, lse


def flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = False, window: Optional[int] = None,
                  scale: Optional[float] = None,
                  logit_cap: Optional[float] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """softmax(cap(Q K^T * scale)) V over [B, S, H, D] -> (out, lse).

    k/v may carry fewer heads [B, S, Kv, D] (GQA, H % Kv == 0). window:
    sliding band (causal only), row i sees cols (i - window, i]. scale
    defaults to 1/sqrt(D); logit_cap is the Gemma-2 tanh softcap, applied
    before the mask. A CUDA tensor launches `csrc/flash_fwd.cu` and adds
    one to `flash_forward.launches`; a CPU tensor takes
    `flash_forward_reference`."""
    _check_args(q, k, v, causal, window, logit_cap)
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    if q.device.type == "cpu":
        return flash_forward_reference(q, k, v, causal, window, scale,
                                       logit_cap)
    if q.device.type != "cuda":
        raise ValueError(f"flash_forward runs on CUDA or the CPU, not "
                         f"{q.device}")
    return _launch(q, k, v, causal, window, scale, logit_cap)


#: launches of the CUDA kernel since the last reset (the count a run reads
#: to show that its main path went through the kernel)
flash_forward.launches = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, window: Optional[int] = None,
                    scale: Optional[float] = None,
                    logit_cap: Optional[float] = None) -> torch.Tensor:
    """The output of `flash_forward`. Forward only: the kernel has no
    backward yet, so a CUDA call that needs gradients raises."""
    if (q.device.type == "cuda" and torch.is_grad_enabled()
            and any(t.requires_grad for t in (q, k, v))):
        raise NotImplementedError(
            "the CUDA flash kernel is forward-only; its backward "
            "(_dkv_kernel/_dq_kernel) comes with the training slice")
    out, _ = flash_forward(q, k, v, causal, window, scale, logit_cap)
    return out
