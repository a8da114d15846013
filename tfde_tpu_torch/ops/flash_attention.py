"""Flash attention, forward and backward — hand-written CUDA kernels for
Hopper.

Counterpart of `tfde_tpu/ops/flash_attention.py`. The Pallas forward
(`_fwd_kernel`, launched by `_flash_forward`) becomes `csrc/flash_fwd.cu`;
the Pallas backward pair (`_dkv_kernel`, `_dq_kernel`, launched by
`_bwd_pallas`) becomes the two kernels of `csrc/flash_bwd.cu`. Each is
built with nvcc for sm_90a into a plain C library and bound with ctypes
(`utils/build.py`). `flash_forward` and `flash_backward` dispatch on the
tensor they are given: a CUDA tensor launches the kernels (or raises), a
CPU tensor takes `flash_forward_reference` / `flash_backward_reference`,
the plain PyTorch versions of the same functions — which are also what
`chip_smoke.py` holds the kernels against on the card.

`flash_attention` is differentiable: a `torch.autograd.Function` saves
q, k, v, out and lse from the forward, and its backward is
`flash_backward`. On CUDA that is the hand-written pair whatever the
shape the forward takes (GQA included, which the Pallas pair is not);
the TPU's choice of the blockwise JAX recurrence as its default backward
(a v5e measurement) does not carry over, and there is no knob.

The band helpers (`_tile_in_band`, `_band_tile_pairs`, `bwd_tile_plan`)
are the JAX package's, as pure Python: the kernels' tile loops run over
exactly the tiles that `_tile_in_band` accepts.
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
    CUDA kernels' own tiles are set in csrc/ (the bf16 kernels' 128-row
    blocks, the fp32 kernels' 64 x 64)."""
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


def _delta(out: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) in fp32, [B, H, S]: computed outside the
    kernels, as `_bwd_pallas` keeps it outside its Pallas pair."""
    return (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def _check_backward_args(q, out, lse, do) -> None:
    b, s, h, _ = q.shape
    if out.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"out {tuple(out.shape)} and dO {tuple(do.shape)} "
                         f"must have q's shape {tuple(q.shape)}")
    if lse.shape != (b, h, s) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be float32 [B, H, S] = {(b, h, s)}; got "
                         f"{lse.dtype} {tuple(lse.shape)}")


def flash_backward_reference(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, out: torch.Tensor,
                             lse: torch.Tensor, do: torch.Tensor,
                             causal: bool = False,
                             window: Optional[int] = None,
                             scale: Optional[float] = None,
                             logit_cap: Optional[float] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """The plain PyTorch version of the backward pair: the whole [S, S] P
    recomputed from lse in fp32 (masked with -1e30 after the cap), dS =
    P (dO V^T - delta) [(1 - tanh^2) under a cap] scale, then dQ = dS K,
    dK = dS^T Q, dV = P^T dO. Query heads carry a group axis, so dK and
    dV sum over each KV head's query group (`_bwd_pair_scan`'s
    einsums). Returns (dq, dk, dv) in the dtypes of q, k, v."""
    _check_args(q, k, v, causal, window, logit_cap)
    _check_backward_args(q, out, lse, do)
    b, s, h, d = q.shape
    kv = k.shape[2]
    g = h // kv
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    qf = q.float().reshape(b, s, kv, g, d)
    dof = do.float().reshape(b, s, kv, g, d)
    kf, vf = k.float(), v.float()
    delta = _delta(out, do).reshape(b, kv, g, s)
    z = torch.einsum("bqcgd,bkcd->bcgqk", qf, kf) * scale
    t = None
    if logit_cap is not None:
        t = torch.tanh(z / logit_cap)
        z = logit_cap * t
    if causal:
        rows = torch.arange(s, device=q.device)[:, None]
        cols = torch.arange(s, device=q.device)[None, :]
        keep = rows >= cols
        if window is not None:
            keep = keep & (rows - cols < window)
        z = z.masked_fill(~keep, _NEG)
    p = torch.exp(z - lse.reshape(b, kv, g, s)[..., None])
    dv = torch.einsum("bcgqk,bqcgd->bkcd", p, dof)
    ds = p * (torch.einsum("bqcgd,bkcd->bcgqk", dof, vf) - delta[..., None])
    if t is not None:
        ds = ds * (1.0 - t * t)
    ds = ds * scale
    dq = torch.einsum("bcgqk,bkcd->bqcgd", ds, kf).reshape(b, s, h, d)
    dk = torch.einsum("bcgqk,bqcgd->bkcd", ds, qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


_TAIL = (ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
         ctypes.c_int, ctypes.c_void_p)

#: ctypes signature of `tfde_flash_fwd` in csrc/flash_fwd.cu: q, k, v, out,
#: lse pointers; B, S, H, KV, D; the B/S/H element strides of q, k, v and
#: out; causal, window, scale, logit_cap, dtype; the CUDA stream
ARGTYPES = ((ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 5
            + (ctypes.c_longlong,) * 12 + _TAIL)

#: ctypes signature of `tfde_flash_bwd_dkv` in csrc/flash_bwd.cu: q, k, v,
#: dO, lse, delta, dk, dv pointers; B, S, H, KV, D; the B/S/H element
#: strides of q, k, v, dO, dk and dv; causal, window, scale, logit_cap,
#: dtype; the CUDA stream
DKV_ARGTYPES = ((ctypes.c_void_p,) * 8 + (ctypes.c_int,) * 5
                + (ctypes.c_longlong,) * 18 + _TAIL)

#: ctypes signature of `tfde_flash_bwd_dq`: as `tfde_flash_bwd_dkv` with
#: one output, dq, in place of dk and dv
DQ_ARGTYPES = ((ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 5
               + (ctypes.c_longlong,) * 15 + _TAIL)

#: the kernel sources under csrc/ and the C entry points each one binds
SOURCES = {
    "flash_fwd.cu": {"tfde_flash_fwd": ARGTYPES},
    "flash_bwd.cu": {"tfde_flash_bwd_dkv": DKV_ARGTYPES,
                     "tfde_flash_bwd_dq": DQ_ARGTYPES},
}

_LIBS = {}


def build(source: str = "flash_fwd.cu", force: bool = False):
    """Compile (or reuse) `csrc/<source>` (a key of `SOURCES`) and bind its
    C entry points. Returns the `utils.build.KernelLibrary`; raises if
    nvcc or the load fails."""
    if source not in _LIBS or force:
        lib = build_library(source, force=force)
        for name, argtypes in SOURCES[source].items():
            fn = getattr(lib.lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _LIBS[source] = lib
    return _LIBS[source]


def _check_launchable(*tensors: torch.Tensor) -> None:
    """What every kernel of this module takes: one CUDA device, float32 or
    bfloat16 throughout, head_dim 64 or 128, a contiguous head dim and,
    for bf16, 16-byte aligned rows."""
    q = tensors[0]
    d = q.shape[-1]
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(
            f"the CUDA flash kernels take head_dim {KERNEL_HEAD_DIMS}, got {d}")
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in tensors):
        raise ValueError(
            f"the CUDA flash kernels take float32 or bfloat16 tensors of one "
            f"dtype; got {[t.dtype for t in tensors]}")
    if any(t.device != q.device for t in tensors):
        raise ValueError("the CUDA flash kernels' tensors must lie on one "
                         "CUDA device")
    if any(t.stride(-1) != 1 for t in tensors):
        raise ValueError("the CUDA flash kernels need a contiguous head dim")
    if q.dtype == torch.bfloat16 and any(
            t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:3])
            for t in tensors):
        raise ValueError("the bf16 CUDA flash kernels read 16-byte vectors: "
                         "every tensor needs 16-byte aligned rows")


#: what a C entry point returns, plus the CUDA driver's CUresult, when the
#: driver refuses a TMA tensor map (`TMA_ENCODE_ERROR` in
#: csrc/flash_common.cuh; above every cudaError_t)
TMA_ENCODE_ERROR = 10000


def _call(source: str, name: str, device: torch.device, *args) -> None:
    fn = getattr(build(source).lib, name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err >= TMA_ENCODE_ERROR:
        raise RuntimeError(f"{name}: the CUDA driver refused a TMA tensor map "
                           f"(CUresult {err - TMA_ENCODE_ERROR})")
    if err:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")


def _opts(causal, window, scale, logit_cap, dtype) -> tuple:
    return (int(causal), 0 if window is None else int(window), float(scale),
            0.0 if logit_cap is None else float(logit_cap), _DTYPES[dtype])


def _launch(q, k, v, causal, window, scale, logit_cap):
    _check_launchable(q, k, v)
    b, s, h, d = q.shape
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    _call("flash_fwd.cu", "tfde_flash_fwd", q.device,
          q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
          lse.data_ptr(), b, s, h, k.shape[2], d,
          *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
          *out.stride()[:3], *_opts(causal, window, scale, logit_cap,
                                    q.dtype))
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


def flash_bwd_dkv(q, k, v, do, lse, delta, causal=False, window=None,
                  scale=None, logit_cap=None):
    """dK, dV [B, S, Kv, D] from `csrc/flash_bwd.cu`'s dK/dV kernel (CUDA
    tensors only; `flash_backward` is the entry point). Adds one to
    `flash_backward.dkv_launches`."""
    _check_launchable(q, k, v, do)
    b, s, h, d = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _call("flash_bwd.cu", "tfde_flash_bwd_dkv", q.device,
          q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
          lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
          b, s, h, k.shape[2], d,
          *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
          *do.stride()[:3], *dk.stride()[:3], *dv.stride()[:3],
          *_opts(causal, window, scale, logit_cap, q.dtype))
    flash_backward.dkv_launches += 1
    return dk, dv


def flash_bwd_dq(q, k, v, do, lse, delta, causal=False, window=None,
                 scale=None, logit_cap=None):
    """dQ [B, S, H, D] from `csrc/flash_bwd.cu`'s dQ kernel (CUDA tensors
    only). Adds one to `flash_backward.dq_launches`."""
    _check_launchable(q, k, v, do)
    b, s, h, d = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _call("flash_bwd.cu", "tfde_flash_bwd_dq", q.device,
          q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
          lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
          b, s, h, k.shape[2], d,
          *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
          *do.stride()[:3], *dq.stride()[:3],
          *_opts(causal, window, scale, logit_cap, q.dtype))
    flash_backward.dq_launches += 1
    return dq


def flash_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   out: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                   causal: bool = False, window: Optional[int] = None,
                   scale: Optional[float] = None,
                   logit_cap: Optional[float] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of `flash_forward`'s out for the output gradient dO,
    from the forward's residuals (q, k, v, out, lse) and its options.

    A CUDA tensor computes delta = rowsum(dO * O) in fp32 and launches the
    two kernels of `csrc/flash_bwd.cu` (dK/dV, then dQ), adding one to
    `flash_backward.dkv_launches` and `.dq_launches`; a CPU tensor takes
    `flash_backward_reference`."""
    _check_args(q, k, v, causal, window, logit_cap)
    _check_backward_args(q, out, lse, do)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return flash_backward_reference(q, k, v, out, lse, do, causal,
                                        window, scale, logit_cap)
    if q.device.type != "cuda":
        raise ValueError(f"flash_backward runs on CUDA or the CPU, not "
                         f"{q.device}")
    if lse.device != q.device or not lse.is_contiguous():
        raise ValueError("the CUDA flash backward reads lse as a contiguous "
                         "[B, H, S] tensor on q's device")
    delta = _delta(out, do)
    opts = (causal, window, scale, logit_cap)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, *opts)
    dq = flash_bwd_dq(q, k, v, do, lse, delta, *opts)
    return dq, dk, dv


#: launches of the two CUDA backward kernels since the last reset
flash_backward.dkv_launches = 0
flash_backward.dq_launches = 0


class _FlashAttention(torch.autograd.Function):
    """`flash_forward`'s out, with `flash_backward` as its gradient (the
    JAX package's `flash_attention` custom VJP)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, logit_cap):
        out, lse = flash_forward(q, k, v, causal, window, scale, logit_cap)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = (causal, window, scale, logit_cap)
        return out

    @staticmethod
    def backward(ctx, do):
        dq, dk, dv = flash_backward(*ctx.saved_tensors, do.contiguous(),
                                    *ctx.opts)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, window: Optional[int] = None,
                    scale: Optional[float] = None,
                    logit_cap: Optional[float] = None) -> torch.Tensor:
    """The output of `flash_forward`, differentiable in q, k and v: when a
    gradient is wanted the call goes through `_FlashAttention`, whose
    backward is `flash_backward`."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, causal, window, scale,
                                     logit_cap)
    out, _ = flash_forward(q, k, v, causal, window, scale, logit_cap)
    return out
