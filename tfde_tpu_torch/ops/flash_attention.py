"""Flash attention, forward and backward — hand-written CUDA kernels for
Hopper.

Counterpart of `tfde_tpu/ops/flash_attention.py`. The Pallas forward
(`_fwd_kernel`, launched by `_flash_forward`) becomes `csrc/flash_fwd.cu`;
the Pallas backward pair (`_dkv_kernel`, `_dq_kernel`, launched by
`_bwd_pallas`) becomes the two kernels of `csrc/flash_bwd.cu`. Each is
built with nvcc for sm_90a into a plain C library and bound with ctypes
(`utils/build.py`).

The three kernels are `torch.library` custom ops — `tfde::flash_forward`,
`tfde::flash_bwd_dkv` and `tfde::flash_bwd_dq` — so that PyTorch's tracers
see them as single operations: `torch.export` records them in an exported
program (export/serving.py, export/generative.py), and a fake
implementation gives each one's output shapes and dtypes without running
it. Each op's CUDA implementation launches its kernel through the ctypes
binding (or raises) and adds one to its launch counter; its CPU
implementation is the plain PyTorch version of the same function
(`flash_forward_reference`, `flash_backward_reference`), which is also
what `chip_smoke.py` holds the kernels against on the card.
`flash_forward` and `flash_backward` are the entry points.

The kernels are compiled for head dims 64, 128 and 256. On a CUDA tensor
any other head dim up to 256 (Phi-2's 80, Phi-3's 96, 160) is zero-padded
to the next of them on the way in and the outputs and gradients are cut
back (`padded_forward`, `padded_backward`): a zero column adds nothing to
Q K^T and the padded V columns give zero outputs, so this is the
unpadded function, at the real head dim's scale. A head dim above 256
raises (`kernel_head_dim`; no converted family has one).

`flash_attention` is differentiable: the forward op's autograd formula
(`torch.library.register_autograd`) saves q, k, v, out and lse, and its
backward is `flash_backward`. On CUDA that is the hand-written pair
whatever the shape the forward takes (GQA included, which the Pallas pair
is not); the TPU's choice of the blockwise JAX recurrence as its default
backward (a v5e measurement) does not carry over, and there is no knob.

The band helpers (`_tile_in_band`, `_band_tile_pairs`, `bwd_tile_plan`)
are the JAX package's, as pure Python: the kernels' tile loops run over
exactly the tiles that `_tile_in_band` accepts.
"""

from __future__ import annotations

import ctypes
import math
from collections import Counter
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from tfde_tpu_torch.utils.build import build_library

_NEG = -1e30

#: head dims the kernel is compiled for
KERNEL_HEAD_DIMS = (64, 128, 256)

#: where the port's queue names the head dims the kernels do not take
#: (above 256: no converted family has one)
HEAD_DIM_ABOVE_256_ITEM = ("ROADMAP.md, queue 2: the flash kernels at head "
                           "dims above 256")

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
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return _backward_plain(q, k, v, do, lse, _delta(out, do), causal, window,
                           scale, logit_cap)


def _backward_plain(q, k, v, do, lse, delta, causal, window, scale,
                    logit_cap):
    """`flash_backward_reference` from delta = rowsum(dO * O) [B, H, S]:
    what the backward ops take in place of out."""
    b, s, h, d = q.shape
    kv = k.shape[2]
    g = h // kv
    qf = q.float().reshape(b, s, kv, g, d)
    dof = do.float().reshape(b, s, kv, g, d)
    kf, vf = k.float(), v.float()
    delta = delta.reshape(b, kv, g, s)
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


def kernel_head_dim(d: int) -> int:
    """The head dim the kernels run a head dim `d` at: the smallest of
    `KERNEL_HEAD_DIMS` that is not below it (`d` itself for 64, 128 and
    256). Raises ValueError above 256."""
    for dp in KERNEL_HEAD_DIMS:
        if d <= dp:
            return dp
    raise ValueError(
        f"the CUDA flash kernels take head_dim up to "
        f"{KERNEL_HEAD_DIMS[-1]}, got {d} ({HEAD_DIM_ABOVE_256_ITEM})")


def _pad_head_dim(t: torch.Tensor, dp: int) -> torch.Tensor:
    return F.pad(t, (0, dp - t.shape[-1]))


def padded_forward(forward, q, k, v, causal, window, scale, logit_cap):
    """`forward` (the kernel's launch, or a plain version) on q, k, v
    zero-padded to `kernel_head_dim`, the output cut back to the real head
    dim; `scale` must already be the real head dim's (or the caller's).
    The padding adds zero to every score and gives zero output columns,
    so out and lse are the unpadded function's."""
    d = q.shape[-1]
    dp = kernel_head_dim(d)
    if dp == d:
        return forward(q, k, v, causal, window, scale, logit_cap)
    out, lse = forward(*(_pad_head_dim(t, dp) for t in (q, k, v)), causal,
                       window, scale, logit_cap)
    return out[..., :d].contiguous(), lse


def padded_backward(backward, q, k, v, out, lse, do, causal, window, scale,
                    logit_cap):
    """`backward` (the kernels' pair, or a plain version) on q, k, v, out
    and dO zero-padded as in `padded_forward`, the gradients cut back to
    the real head dim. delta = rowsum(dO * O) and P are unchanged by the
    zero columns, so dq, dk and dv are the unpadded function's."""
    d = q.shape[-1]
    dp = kernel_head_dim(d)
    if dp == d:
        return backward(q, k, v, out, lse, do, causal, window, scale,
                        logit_cap)
    q, k, v, out, do = (_pad_head_dim(t, dp) for t in (q, k, v, out, do))
    grads = backward(q, k, v, out, lse, do, causal, window, scale,
                     logit_cap)
    return tuple(g[..., :d].contiguous() for g in grads)


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
    bfloat16 throughout, head_dim 64, 128 or 256 (`flash_forward` and
    `flash_backward` pad any other up to 256), a contiguous head dim and,
    for bf16, 16-byte aligned rows."""
    q = tensors[0]
    d = q.shape[-1]
    if d not in KERNEL_HEAD_DIMS:
        kernel_head_dim(d)  # raises above 256, naming the queue item
        raise ValueError(
            f"the CUDA flash kernels take head_dim {KERNEL_HEAD_DIMS}, got "
            f"{d}; flash_forward and flash_backward pad it")
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in tensors):
        raise ValueError(
            f"the CUDA flash kernels take float32 or bfloat16 tensors of one "
            f"dtype; got {[t.dtype for t in tensors]}")
    if any(t.device != q.device for t in tensors):
        raise ValueError("the CUDA flash kernels' tensors must lie on one "
                         "CUDA device")
    if any(t.stride(-1) != 1 for t in tensors):
        raise ValueError("the CUDA flash kernels need a contiguous head dim")
    # alignment from the storage offset (an allocation's base is aligned;
    # a fake tensor, as tracers pass, has no data pointer)
    if q.dtype == torch.bfloat16 and any(
            t.storage_offset() % 8 or any(st % 8 for st in t.stride()[:3])
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
    flash_forward.by_head_dim[d] += 1
    return out, lse


# ------------------------------------------------------------ custom ops --
# Each op's CUDA implementation launches its kernel (`_check_launchable`
# raises on what the kernel does not take; the entry points below check
# the same before they call an op on a CUDA tensor, so a tracer meets the
# error too); its CPU implementation is the plain version; its fake
# implementation gives the outputs' shapes and dtypes to tracers
# (FakeTensorMode, torch.export). Options are typed for the op schema:
# `scale` is resolved by the caller.

@torch.library.custom_op("tfde::flash_forward", mutates_args=(),
                         device_types="cuda")
def _forward_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                causal: bool, window: Optional[int], scale: float,
                logit_cap: Optional[float]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    return _launch(q, k, v, causal, window, scale, logit_cap)


@_forward_op.register_kernel("cpu")
def _(q, k, v, causal, window, scale, logit_cap):
    out, lse = flash_forward_reference(q, k, v, causal, window, scale,
                                       logit_cap)
    return out.contiguous(), lse.contiguous()


@_forward_op.register_fake
def _(q, k, v, causal, window, scale, logit_cap):
    b, s, h, _ = q.shape
    return (q.new_empty(q.shape),
            q.new_empty((b, h, s), dtype=torch.float32))


def _forward_setup_context(ctx, inputs, output):
    q, k, v, causal, window, scale, logit_cap = inputs
    out, lse = output
    ctx.save_for_backward(q, k, v, out, lse)
    ctx.opts = (causal, window, scale, logit_cap)
    ctx.mark_non_differentiable(lse)
    # lse has no gradient: no zero tensor (one fill kernel a call) for it
    ctx.set_materialize_grads(False)


def _forward_backward(ctx, dout, _dlse):
    # lse is not differentiable: backward runs only when out has a gradient
    dq, dk, dv = flash_backward(*ctx.saved_tensors, dout.contiguous(),
                                *ctx.opts)
    return dq, dk, dv, None, None, None, None


_forward_op.register_autograd(_forward_backward,
                              setup_context=_forward_setup_context)


def _launch_dkv(q, k, v, do, lse, delta, causal, window, scale, logit_cap):
    _check_launchable(q, k, v, do)
    b, s, h, d = q.shape
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
    flash_backward.dkv_by_head_dim[d] += 1
    return dk, dv


@torch.library.custom_op("tfde::flash_bwd_dkv", mutates_args=(),
                         device_types="cuda")
def _dkv_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
            causal: bool, window: Optional[int], scale: float,
            logit_cap: Optional[float]) -> Tuple[torch.Tensor, torch.Tensor]:
    return _launch_dkv(q, k, v, do, lse, delta, causal, window, scale,
                       logit_cap)


@_dkv_op.register_kernel("cpu")
def _(q, k, v, do, lse, delta, causal, window, scale, logit_cap):
    _, dk, dv = _backward_plain(q, k, v, do, lse, delta, causal, window,
                                scale, logit_cap)
    return dk.contiguous(), dv.contiguous()


@_dkv_op.register_fake
def _(q, k, v, do, lse, delta, causal, window, scale, logit_cap):
    return k.new_empty(k.shape), v.new_empty(v.shape)


def _launch_dq(q, k, v, do, lse, delta, causal, window, scale, logit_cap):
    _check_launchable(q, k, v, do)
    b, s, h, d = q.shape
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _call("flash_bwd.cu", "tfde_flash_bwd_dq", q.device,
          q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
          lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
          b, s, h, k.shape[2], d,
          *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
          *do.stride()[:3], *dq.stride()[:3],
          *_opts(causal, window, scale, logit_cap, q.dtype))
    flash_backward.dq_launches += 1
    flash_backward.dq_by_head_dim[d] += 1
    return dq


@torch.library.custom_op("tfde::flash_bwd_dq", mutates_args=(),
                         device_types="cuda")
def _dq_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
           causal: bool, window: Optional[int], scale: float,
           logit_cap: Optional[float]) -> torch.Tensor:
    return _launch_dq(q, k, v, do, lse, delta, causal, window, scale,
                      logit_cap)


@_dq_op.register_kernel("cpu")
def _(q, k, v, do, lse, delta, causal, window, scale, logit_cap):
    return _backward_plain(q, k, v, do, lse, delta, causal, window, scale,
                           logit_cap)[0].contiguous()


@_dq_op.register_fake
def _(q, k, v, do, lse, delta, causal, window, scale, logit_cap):
    return q.new_empty(q.shape)


def flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = False, window: Optional[int] = None,
                  scale: Optional[float] = None,
                  logit_cap: Optional[float] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """softmax(cap(Q K^T * scale)) V over [B, S, H, D] -> (out, lse).

    k/v may carry fewer heads [B, S, Kv, D] (GQA, H % Kv == 0). window:
    sliding band (causal only), row i sees cols (i - window, i]. scale
    defaults to 1/sqrt(D); logit_cap is the Gemma-2 tanh softcap, applied
    before the mask. Runs the op `tfde::flash_forward`: a CUDA tensor
    launches `csrc/flash_fwd.cu` (any head dim up to 256 other than 64,
    128 and 256 zero-padded, `padded_forward`) and adds one to
    `flash_forward.launches` (and to `flash_forward.by_head_dim` at the
    kernel's head dim); a CPU tensor takes `flash_forward_reference`."""
    _check_args(q, k, v, causal, window, logit_cap)
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    scale = float(scale)
    if q.device.type == "cpu":
        return _forward_op(q, k, v, causal, window, scale, logit_cap)
    if q.device.type != "cuda":
        raise ValueError(f"flash_forward runs on CUDA or the CPU, not "
                         f"{q.device}")
    return padded_forward(_checked_forward_op, q, k, v, causal, window,
                          scale, logit_cap)


def _checked_forward_op(q, k, v, causal, window, scale, logit_cap):
    _check_launchable(q, k, v)
    return _forward_op(q, k, v, causal, window, scale, logit_cap)


#: launches of the CUDA kernel since the last reset (the count a run reads
#: to show that its main path went through the kernel), and the same
#: launches by the kernel's head dim (64, 128, 256)
flash_forward.launches = 0
flash_forward.by_head_dim = Counter()


def flash_bwd_dkv(q, k, v, do, lse, delta, causal=False, window=None,
                  scale=None, logit_cap=None):
    """dK, dV [B, S, Kv, D] from the op `tfde::flash_bwd_dkv`: on CUDA
    tensors `csrc/flash_bwd.cu`'s dK/dV kernel, which adds one to
    `flash_backward.dkv_launches` (`flash_backward` is the entry point)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cuda":
        _check_launchable(q, k, v, do)
    return _dkv_op(q, k, v, do, lse, delta, causal, window, float(scale),
                   logit_cap)


def flash_bwd_dq(q, k, v, do, lse, delta, causal=False, window=None,
                 scale=None, logit_cap=None):
    """dQ [B, S, H, D] from the op `tfde::flash_bwd_dq`: on CUDA tensors
    `csrc/flash_bwd.cu`'s dQ kernel, which adds one to
    `flash_backward.dq_launches`."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cuda":
        _check_launchable(q, k, v, do)
    return _dq_op(q, k, v, do, lse, delta, causal, window, float(scale),
                  logit_cap)


def flash_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   out: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                   causal: bool = False, window: Optional[int] = None,
                   scale: Optional[float] = None,
                   logit_cap: Optional[float] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of `flash_forward`'s out for the output gradient dO,
    from the forward's residuals (q, k, v, out, lse) and its options.

    A CUDA tensor computes delta = rowsum(dO * O) in fp32 and runs the ops
    `tfde::flash_bwd_dkv` and `tfde::flash_bwd_dq` (the two kernels of
    `csrc/flash_bwd.cu`; a head dim other than 64, 128 and 256 zero-padded,
    `padded_backward`), adding one to `flash_backward.dkv_launches` and
    `.dq_launches` (and to `.dkv_by_head_dim` / `.dq_by_head_dim` at the
    kernels' head dim); a CPU tensor takes `flash_backward_reference`."""
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
    return padded_backward(_launch_backward, q, k, v, out, lse, do, causal,
                           window, scale, logit_cap)


def _launch_backward(q, k, v, out, lse, do, causal, window, scale,
                     logit_cap):
    delta = _delta(out, do)
    opts = (causal, window, scale, logit_cap)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, *opts)
    dq = flash_bwd_dq(q, k, v, do, lse, delta, *opts)
    return dq, dk, dv


#: launches of the two CUDA backward kernels since the last reset, in
#: total and by head dim
flash_backward.dkv_launches = 0
flash_backward.dq_launches = 0
flash_backward.dkv_by_head_dim = Counter()
flash_backward.dq_by_head_dim = Counter()


def reset_launches() -> None:
    """Set every kernel's launch counters, totals and by head dim, to
    zero."""
    flash_forward.launches = 0
    flash_backward.dkv_launches = 0
    flash_backward.dq_launches = 0
    for counts in (flash_forward.by_head_dim, flash_backward.dkv_by_head_dim,
                   flash_backward.dq_by_head_dim):
        counts.clear()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, window: Optional[int] = None,
                    scale: Optional[float] = None,
                    logit_cap: Optional[float] = None) -> torch.Tensor:
    """The output of `flash_forward`, differentiable in q, k and v through
    the forward op's autograd formula, whose backward is
    `flash_backward`."""
    return flash_forward(q, k, v, causal, window, scale, logit_cap)[0]
