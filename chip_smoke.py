#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`tfde_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero
without printing a result:

1. device — the card's name and power limit from nvidia-smi;
2. build  — compile every kernel source of the serving and training paths
   (tfde_tpu_torch/csrc/flash_fwd.cu, flash_bwd.cu) with nvcc (sm_90a),
   one nvcc per source, all started together; count each bf16 kernel's
   wgmma (HGMMA) and TMA (UTMALDG) instructions in `cuobjdump -sass` (the
   forward and the dK/dV kernel must have both), and time one tensor-map
   encode on the host;
3. kernels — each kernel against its plain PyTorch version on the card,
   over the slice shape and the option matrix (the forward's out and lse;
   the backward pair's dq, dk and dv), then its time beside the plain
   version's, the library call's (SDPA's forward, SDPA's backward; timing
   only) and the bound; then the forward and dK/dV at D 128;
4. parity — a small fp32 GPT with head_dim 64: logits of the CUDA model
   (flash prefill) against the same weights on the CPU (plain attention),
   and the CUDA batcher's greedy tokens against CPU `generate`;
5. train parity — the same kind of GPT takes one next_token_loss + AdamW
   step on CUDA (flash forward and backward kernels) and on the CPU
   (plain versions): loss, every gradient and the updated parameters;
6. serve  — GPT-2 small at full width (768 x 12 layers, 12 heads, MLP
   3072, vocab 50257, 1024 positions, bf16, random weights from seed 0)
   behind a ContinuousBatcher (batch 8, max_len 1024, scan depth 4,
   greedy) answering 16 requests of 16-960 prompt tokens x 32 new tokens;
   the launch counters are zeroed just before and read just after, and
   the flash kernel must have run 12 times per prefill wave; then one
   wave's first-token logits with attn_impl flash vs reference;
7. train  — GPT-2 small at full width, fp32 master weights, bf16 compute,
   random weights from seed 0, 20 steps of batch 8 x 1024 tokens of
   `synthetic_tokens` (masked AdamW, lr 3e-4, warmup 5, cosine over 20,
   weight decay 0.1); the counters are zeroed just before and read just
   after: each of the three kernels must have run 12 x 20 times, every
   loss must be finite and the last below the first.

The last two lines are the kernels JSON line and
{"ok": true, "device": {...}}. The script imports nothing of JAX.
`--phases kernels,train` (any subset of the phases after the build) runs
only those, prints no result line and exits 1: the parent/change A/B of
kernel and train times.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

#: H100 SXM data-sheet peaks (dense)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
#: tolerances of a kernel against its plain version: out relative
#: Frobenius, lse max abs. bf16: the output's rounding to bf16; fp32: the
#: same sums in another order.
TOL = {torch.bfloat16: (1e-2, 1e-3), torch.float32: (1e-5, 1e-5)}
#: tolerance of the backward pair against its plain version, dq, dk and dv
#: each in relative Frobenius. bf16: P and dS are rounded to bf16 before
#: the products (as the TPU kernels do), the plain version keeps them fp32;
#: fp32: the same sums in another order.
BWD_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-5}
#: clock cycles of the spin kernel ahead of each timed call (~5 ms at the
#: H100's 1.98 GHz boost clock; ~1 ms still let the first timed call of
#: SDPA's backward wait for the host)
SPIN_CYCLES = 10_000_000


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _grads_rel(got: dict, want: dict) -> float:
    """Worst relative Frobenius error over a model's gradients. A gradient
    whose reference norm is below 1e-6 of the global norm is zero in exact
    arithmetic (the key bias: a shift shared by a row's logits leaves the
    softmax unchanged) and rounding noise in both: it must be that small
    on both sides, and is then not compared relatively."""
    total = math.sqrt(sum(float(w.double().norm()) ** 2
                          for w in want.values()))
    worst = 0.0
    for name, w in want.items():
        if float(w.double().norm()) < 1e-6 * total:
            if float(got[name].double().norm()) >= 1e-6 * total:
                return math.inf
            continue
        worst = max(worst, _rel(got[name], w))
    return worst


def _time_ms(fn, dev, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of `fn` over `iters` launches, each after a write
    of 256 MB that evicts the 50 MB L2, timed with CUDA events. A spin
    kernel of ~5 ms runs between the flush and the start event, so the
    host has queued all of `fn` before the card reaches it: the time is
    the card's, not the host's dispatch (autograd's engine thread
    included)."""
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=dev)
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize(dev)
    return sum(s.elapsed_time(e) for s, e in events) / iters


def _visible_pairs(s: int, causal: bool, window) -> int:
    """(query, key) pairs the mask keeps in one [S, S] attention."""
    if not causal:
        return s * s
    if window is None:
        return s * (s + 1) // 2
    return sum(min(i + 1, window) for i in range(s))


def _bound(b, s, h, kv, d, dtype, causal, window, kernel="fwd"):
    """(least ms the H100 needs, 'bytes' | 'operations') for one kernel's
    own work: each input read once and each output written once over HBM
    bandwidth, its products over the peak of the input type.
    fwd: q, k, v in; out, lse out; 2 products (Q K^T, P V), 4*D FLOP a
    visible pair. dkv: q, k, v, dO, lse, delta in; dk, dv out; 4 products
    (K Q^T, V dO^T, P^T dO, dS^T Q), 8*D. dq: the same inputs; dq out; 3
    products (Q K^T, dO V^T, dS K), 6*D."""
    item = torch.tensor([], dtype=dtype).element_size()
    q_elems, kv_elems, rows = b * s * h * d, b * s * kv * d, b * h * s
    nbytes, per_pair = {
        "fwd": ((2 * q_elems + 2 * kv_elems) * item + rows * 4, 4),
        "dkv": ((2 * q_elems + 4 * kv_elems) * item + 2 * rows * 4, 8),
        "dq": ((3 * q_elems + 2 * kv_elems) * item + 2 * rows * 4, 6),
    }[kernel]
    flops = per_pair * d * _visible_pairs(s, causal, window) * b * h
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    lines = smi.stdout.strip().splitlines()
    print(lines[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)} (devices: "
          f"{torch.cuda.device_count()})")


def phase_build(fa):
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(fa.SOURCES)) as pool:
        libs = dict(zip(fa.SOURCES, pool.map(
            lambda src: fa.build(src, force=True), fa.SOURCES)))
    print(f"build: {len(libs)} sources in parallel in "
          f"{time.perf_counter() - t0:.2f} s")
    for src, lib in libs.items():
        print(f"build: {src} -> {os.path.relpath(lib.path)} in "
              f"{lib.seconds:.2f} s")
        for line in lib.log.splitlines():
            if ("Compiling entry" in line or "registers" in line
                    or "spill" in line or "arning" in line
                    or "Performance" in line):
                print(f"  ptxas: {line.strip()}")
    _check_sass(libs)
    _print_encode_time(fa)


#: the kernels redesigned for Hopper: each must have compiled to wgmma
#: (HGMMA) and TMA loads (UTMALDG)
HOPPER_KERNELS = ("flash_fwd_bf16_kernel", "dkv_bf16_kernel")


def _check_sass(libs):
    """Count HGMMA and UTMALDG instructions of each bf16 kernel in
    `cuobjdump -sass` of the built libraries; raise if a redesigned kernel
    has none of either."""
    from tfde_tpu_torch.utils.build import sass_counts

    seen = set()
    for lib in libs.values():
        for symbol, counts in sass_counts(
                lib.path, ("HGMMA", "UTMALDG", "STL", "LDL")).items():
            name = next((k for k in HOPPER_KERNELS + ("dq_bf16_kernel",)
                         if k in symbol), None)
            if name is None:
                continue
            d = 128 if "ILi128E" in symbol else 64
            print(f"sass: {name}<{d}>: HGMMA {counts['HGMMA']}, UTMALDG "
                  f"{counts['UTMALDG']}, local-memory STL {counts['STL']} / "
                  f"LDL {counts['LDL']}")
            if name in HOPPER_KERNELS:
                if not (counts["HGMMA"] and counts["UTMALDG"]):
                    raise AssertionError(f"{name}<{d}> compiled without "
                                         f"wgmma or TMA: {counts}")
                seen.add((name, d))
    want = {(k, d) for k in HOPPER_KERNELS for d in (64, 128)}
    if seen != want:
        raise AssertionError(f"the SASS check found {sorted(seen)}, not "
                             f"{sorted(want)}")


def _print_encode_time(fa):
    """Host time of one TMA tensor-map encode (each bf16 launch of the
    forward encodes 3, of dK/dV 4)."""
    base = torch.empty(8 * 1024 * 12 * 64, dtype=torch.bfloat16,
                       device="cuda")
    fn = fa.build("flash_fwd.cu").lib.tfde_flash_tma_encode_ns
    fn(base.data_ptr(), 100)
    ns = fn(base.data_ptr(), 10000)
    print(f"build: one tensor-map encode takes {ns / 1e3:.2f} us on the host "
          f"(mean of 10000; 3 a forward launch, 4 a dK/dV launch)")


#: (name, B, S, H, KV, D, dtype, causal, window, scale, cap)
CASES = [
    ("slice", 8, 1024, 12, 12, 64, torch.bfloat16, True, None, None, None),
    ("ragged_s200", 2, 200, 12, 12, 64, torch.bfloat16, True, None, None,
     None),
    ("fp32", 2, 256, 4, 4, 64, torch.float32, True, None, None, None),
    ("gqa_window_cap_scale", 2, 384, 8, 2, 64, torch.bfloat16, True, 100,
     0.2, 30.0),
    ("noncausal_d128", 2, 300, 4, 4, 128, torch.bfloat16, False, None,
     None, None),
    ("fp32_gqa_window_cap_d128", 1, 333, 8, 4, 128, torch.float32, True, 70,
     0.1, 20.0),
    # the edges of the 128-row tiles: one row past a tile, the smallest
    # prefill bucket, a window and a ragged edge inside a tile at D 128,
    # and a non-causal ragged edge
    ("s129", 2, 129, 12, 12, 64, torch.bfloat16, True, None, None, None),
    ("s16", 8, 16, 12, 12, 64, torch.bfloat16, True, None, None, None),
    ("gqa_window127_cap_d128", 2, 1000, 8, 2, 128, torch.bfloat16, True, 127,
     None, 30.0),
    ("noncausal_s257", 2, 257, 12, 12, 64, torch.bfloat16, False, None, None,
     None),
]

#: the D 128 timing shape: the slice's model width (768) as 6 heads of 128
D128 = (8, 1024, 6, 6, 128)


def _check_backward(fa, name, q, k, v, causal, window, scale, cap, gen):
    """The backward pair on the card against its plain version on the same
    inputs (the forward kernel's out and lse, one dO): returns the dO, the
    forward's residuals and the max abs error of dq and of dk/dv."""
    dtype = q.dtype
    do = torch.randn(q.shape, generator=gen, device=q.device).to(dtype)
    out, lse = fa.flash_forward(q, k, v, causal, window, scale, cap)
    got = fa.flash_backward(q, k, v, out, lse, do, causal, window, scale,
                            cap)
    torch.cuda.synchronize(q.device)
    want = fa.flash_backward_reference(q, k, v, out, lse, do, causal, window,
                                       scale, cap)
    rels = [_rel(g.float(), w.float()) for g, w in zip(got, want)]
    errs = [float((g.float() - w.float()).abs().max())
            for g, w in zip(got, want)]
    tol = BWD_TOL[dtype]
    ok = (all(g.shape == w.shape for g, w in zip(got, want))
          and all(bool(torch.isfinite(g).all()) for g in got)
          and all(r <= tol for r in rels)
          and all(float(w.float().abs().max()) > 0 for w in want))
    norms = [float(w.float().norm()) for w in want]
    print(f"kernel flash_bwd {name}: dq rel {rels[0]:.3e}, dk rel "
          f"{rels[1]:.3e}, dv rel {rels[2]:.3e} (tol {tol:g}); max abs dq "
          f"{errs[0]:.3e}, dk {errs[1]:.3e}, dv {errs[2]:.3e}; plain norms "
          f"{norms[0]:.3e}, {norms[1]:.3e}, {norms[2]:.3e} -> "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"the flash backward pair disagrees with its "
                             f"plain version on case {name}")
    return do, out, lse, errs[0], max(errs[1], errs[2])


def _time_backward(fa, q, k, v, do, out, lse, causal, dev, result):
    """Times of the backward pair at the slice shape: each kernel alone,
    the plain backward, the pair's total (delta + dkv + dq) and SDPA's
    backward alone (autograd.grad on a kept SDPA graph; timing only)."""
    import torch.nn.functional as F

    b, s, h, d = q.shape
    delta = fa._delta(out, do)
    dkv, dq = result["flash_bwd_dkv"], result["flash_bwd_dq"]
    dkv["ms"] = _time_ms(
        lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal), dev)
    dq["ms"] = _time_ms(
        lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, causal), dev)
    plain = _time_ms(lambda: fa.flash_backward_reference(
        q, k, v, out, lse, do, causal), dev, iters=5)
    pair = _time_ms(
        lambda: fa.flash_backward(q, k, v, out, lse, do, causal), dev)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    ref = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    dot = do.transpose(1, 2)
    library = _time_ms(lambda: torch.autograd.grad(
        ref, (qt, kt, vt), dot, retain_graph=True), dev)
    for entry, kernel in ((dkv, "dkv"), (dq, "dq")):
        entry["plain_ms"] = plain
        entry["library_ms"] = library
        entry["bound_ms"], entry["bound_by"] = _bound(
            b, s, h, k.shape[2], d, q.dtype, causal, None, kernel)
    print(f"kernel flash_bwd slice timing: dkv_ms {dkv['ms']:.4f} (bound "
          f"{dkv['bound_ms']:.4f}, {dkv['bound_by']}), dq_ms "
          f"{dq['ms']:.4f} (bound {dq['bound_ms']:.4f}, {dq['bound_by']}), "
          f"pair total (delta + dkv + dq) {pair:.4f}, plain_ms {plain:.4f}, "
          f"library_ms (SDPA backward alone) {library:.4f}")
    return pair


def phase_kernels(fa, dev):
    import torch.nn.functional as F

    gen = torch.Generator(device=dev).manual_seed(1)
    result = {"flash_fwd": {}, "flash_bwd_dkv": {}, "flash_bwd_dq": {}}
    fwd = result["flash_fwd"]
    for name, b, s, h, kv, d, dtype, causal, window, scale, cap in CASES:
        q = torch.randn((b, s, h, d), generator=gen, device=dev).to(dtype)
        k = torch.randn((b, s, kv, d), generator=gen, device=dev).to(dtype)
        v = torch.randn((b, s, kv, d), generator=gen, device=dev).to(dtype)
        out, lse = fa.flash_forward(q, k, v, causal, window, scale, cap)
        torch.cuda.synchronize(dev)
        ref_out, ref_lse = fa.flash_forward_reference(q, k, v, causal,
                                                      window, scale, cap)
        out_rel = _rel(out.float(), ref_out.float())
        lse_err = float((lse - ref_lse).abs().max())
        max_abs = float((out.float() - ref_out.float()).abs().max())
        tol_out, tol_lse = TOL[dtype]
        ok = (out.shape == ref_out.shape and lse.shape == ref_lse.shape
              and bool(torch.isfinite(out).all())
              and out_rel <= tol_out and lse_err <= tol_lse)
        print(f"kernel flash_fwd {name}: B={b} S={s} H={h} KV={kv} D={d} "
              f"{str(dtype).split('.')[-1]} causal={causal} window={window} "
              f"scale={scale} cap={cap}: out rel {out_rel:.3e} (tol "
              f"{tol_out:g}), lse max abs {lse_err:.3e} (tol {tol_lse:g}), "
              f"out max abs {max_abs:.3e} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"flash_fwd disagrees with its plain "
                                 f"version on case {name}")
        do, out, lse, dq_err, dkv_err = _check_backward(
            fa, name, q, k, v, causal, window, scale, cap, gen)
        if name == "slice":
            fwd["max_abs_err"] = max_abs
            result["flash_bwd_dq"]["max_abs_err"] = dq_err
            result["flash_bwd_dkv"]["max_abs_err"] = dkv_err
            fwd["ms"] = _time_ms(
                lambda: fa.flash_forward(q, k, v, causal), dev)
            fwd["plain_ms"] = _time_ms(
                lambda: fa.flash_forward_reference(q, k, v, causal), dev,
                iters=5)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            fwd["library_ms"] = _time_ms(
                lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                       is_causal=True), dev)
            fwd["bound_ms"], fwd["bound_by"] = _bound(
                b, s, h, kv, d, dtype, causal, window)
            print(f"kernel flash_fwd slice timing: kernel_ms "
                  f"{fwd['ms']:.4f}, plain_ms {fwd['plain_ms']:.4f}, "
                  f"library_ms (SDPA) {fwd['library_ms']:.4f}, bound_ms "
                  f"{fwd['bound_ms']:.4f} ({fwd['bound_by']})")
            _time_backward(fa, q, k, v, do, out, lse, causal, dev, result)
    _time_d128(fa, dev, gen)
    return result


def _time_d128(fa, dev, gen):
    """The two redesigned kernels at D 128 (8 x 1024 tokens, 6 heads, bf16,
    causal) beside their bounds and SDPA's forward / backward."""
    import torch.nn.functional as F

    b, s, h, kv, d = D128
    q, k, v, do = (torch.randn((b, s, n, d), generator=gen, device=dev)
                   .to(torch.bfloat16) for n in (h, kv, kv, h))
    out, lse = fa.flash_forward(q, k, v, True)
    delta = fa._delta(out, do)
    fwd_ms = _time_ms(lambda: fa.flash_forward(q, k, v, True), dev)
    dkv_ms = _time_ms(
        lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, True), dev)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    sdpa_fwd = _time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True), dev)
    ref = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    dot = do.transpose(1, 2)
    sdpa_bwd = _time_ms(lambda: torch.autograd.grad(
        ref, (qt, kt, vt), dot, retain_graph=True), dev)
    fb, fby = _bound(b, s, h, kv, d, torch.bfloat16, True, None)
    db, dby = _bound(b, s, h, kv, d, torch.bfloat16, True, None, "dkv")
    print(f"kernel D128 timing ({b} x {s}, {h} heads, D {d}, bf16, causal): "
          f"flash_fwd {fwd_ms:.4f} ms (bound {fb:.4f}, {fby}; SDPA forward "
          f"{sdpa_fwd:.4f}), flash_bwd_dkv {dkv_ms:.4f} ms (bound {db:.4f}, "
          f"{dby}; SDPA backward, whole {sdpa_bwd:.4f})")


def phase_parity(dev):
    from tfde_tpu_torch.inference.decode import generate, init_cache
    from tfde_tpu_torch.inference.server import ContinuousBatcher
    from tfde_tpu_torch.models.gpt import GPT
    from tfde_tpu_torch.ops import flash_attention as fa

    cfg = dict(vocab_size=97, hidden_size=128, depth=2, num_heads=2,
               mlp_dim=256, max_position=64, dtype=torch.float32, seed=3)
    gpu = GPT(device=dev, **cfg)
    cpu = GPT(device="cpu", **cfg)
    cpu.load_state_dict({k: t.cpu() for k, t in gpu.state_dict().items()})
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 97, (3, 40))
    before = fa.flash_forward.launches
    with torch.no_grad():
        got = gpu(torch.as_tensor(ids, device=dev),
                  cache=init_cache(gpu, 3, 48))
        want = cpu(torch.as_tensor(ids), cache=init_cache(cpu, 3, 48))
    rel = _rel(got.cpu(), want)
    if fa.flash_forward.launches - before != cfg["depth"]:
        raise AssertionError("the CUDA prefill did not run the flash kernel")
    print(f"parity: fp32 GPT(D=64) prefill logits, CUDA flash vs CPU plain: "
          f"rel {rel:.3e} (tol 1e-5)")
    if not rel <= 1e-5:
        raise AssertionError("CUDA prefill logits disagree with the CPU")
    srv = ContinuousBatcher(gpu, batch_size=2, max_len=48, scan_depth=4,
                            device=dev)
    prompts = [rng.integers(0, 97, p) for p in (5, 11, 3, 8)]
    rids = [srv.submit(p, 10) for p in prompts]
    done = dict(srv.run())
    same = 0
    for rid, p in zip(rids, prompts):
        toks, lens = generate(cpu, p[None, :], 10, device="cpu")
        same += int(np.array_equal(done[rid],
                                   toks[0, p.size:int(lens[0])].numpy()))
    print(f"parity: CUDA batcher greedy tokens == CPU generate for "
          f"{same}/{len(prompts)} requests")
    if same != len(prompts):
        raise AssertionError("CUDA batcher tokens differ from CPU generate")


def phase_serve(fa, dev):
    from tfde_tpu_torch.inference.decode import init_cache
    from tfde_tpu_torch.inference.server import ContinuousBatcher
    from tfde_tpu_torch.models.gpt import GPT2Small

    model = GPT2Small(vocab_size=50257, max_position=1024,
                      dtype=torch.bfloat16, device=dev,
                      seed=0).cast_compute_weights_()
    srv = ContinuousBatcher(model, batch_size=8, max_len=1024,
                            scan_depth=4, device=dev)
    rng = np.random.default_rng(0)
    plens = rng.integers(16, 961, 16)
    prompts = [rng.integers(0, model.vocab_size, int(p)) for p in plens]
    torch.cuda.synchronize(dev)
    fa.flash_forward.launches = 0
    t0 = time.perf_counter()
    rids = [srv.submit(p, 32) for p in prompts]
    done = dict(srv.run())
    torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    launches = fa.flash_forward.launches
    stats = srv.stats()
    ttft = srv.ttft_ms()
    n_tok = sum(len(t) for t in done.values())
    print(f"serve: GPT-2 small bf16, batch 8, max_len 1024, scan depth 4: "
          f"{len(done)}/16 requests, {n_tok} tokens in {dt:.3f} s "
          f"({n_tok / dt:.1f} tok/s), mean TTFT "
          f"{sum(ttft.values()) / max(len(ttft), 1):.1f} ms")
    print(f"serve: prompt lengths {[int(p) for p in plens]}")
    print(f"serve: stats {json.dumps(stats)}")
    print(f"serve: flash_fwd launches {launches} over "
          f"{stats['prefill_waves']} prefill waves x {model.depth} layers")
    if sorted(done) != sorted(rids):
        raise AssertionError("not every request finished")
    for rid, toks in done.items():
        if len(toks) != 32 or toks.min() < 0 or toks.max() >= 50257:
            raise AssertionError(f"request {rid} returned {toks!r}")
    if not (launches > 0 and launches == model.depth * stats["prefill_waves"]):
        raise AssertionError("the serve path did not run the flash kernel "
                             "once per layer per prefill wave")

    # one wave's first-token logits, flash vs the reference einsum
    wave = prompts[:4]
    bucket = 1 << max(3, math.ceil(math.log2(max(p.size for p in wave))))
    batch = np.zeros((len(wave), bucket), np.int64)
    for i, p in enumerate(wave):
        batch[i, :p.size] = p
    last = torch.as_tensor([p.size - 1 for p in wave], device=dev)
    rows = torch.arange(len(wave), device=dev)
    logits = {}
    with torch.no_grad():
        for impl in ("flash", "reference"):
            model.set_attn_impl(impl)
            h = model.hidden(torch.as_tensor(batch, device=dev),
                             cache=init_cache(model, len(wave), bucket))
            logits[impl] = model.head(h[rows, last])
    model.set_attn_impl("auto")
    rel = _rel(logits["flash"], logits["reference"])
    finite = bool(torch.isfinite(logits["flash"]).all())
    print(f"serve: first-token logits of a {len(wave)} x {bucket} wave, "
          f"flash vs reference: rel {rel:.3e} (tol 2e-2), finite {finite}")
    if not (finite and rel <= 2e-2):
        raise AssertionError("flash and reference prefill logits disagree")
    return launches


def phase_train_parity(fa, dev):
    from tfde_tpu_torch.models.gpt import GPT, next_token_loss
    from tfde_tpu_torch.training.optimizers import adamw
    from tfde_tpu_torch.training.step import init_state

    cfg = dict(vocab_size=97, hidden_size=128, depth=2, num_heads=2,
               mlp_dim=256, max_position=64, dtype=torch.float32, seed=3)
    models = {"cuda": GPT(device=dev, **cfg), "cpu": GPT(device="cpu", **cfg)}
    models["cpu"].load_state_dict(
        {k: t.cpu() for k, t in models["cuda"].state_dict().items()})
    ids = np.random.default_rng(4).integers(0, 97, (4, 40))
    torch.cuda.synchronize(dev)
    before = (fa.flash_forward.launches, fa.flash_backward.dkv_launches,
              fa.flash_backward.dq_launches)
    got = {}
    for where, model in models.items():
        state = init_state(model, adamw(model, 1e-3, weight_decay=0.1))
        loss, _ = next_token_loss(model, torch.as_tensor(ids,
                                                         device=model.device))
        loss.backward()
        grads = {n: p.grad.cpu().clone() for n, p in
                 model.named_parameters()}
        state.apply_gradients()
        params = {n: p.detach().cpu() for n, p in model.named_parameters()}
        got[where] = (float(loss.detach()), grads, params)
    launched = [after - b for after, b in zip(
        (fa.flash_forward.launches, fa.flash_backward.dkv_launches,
         fa.flash_backward.dq_launches), before)]
    (l_gpu, g_gpu, p_gpu), (l_cpu, g_cpu, p_cpu) = got["cuda"], got["cpu"]
    loss_rel = abs(l_gpu - l_cpu) / abs(l_cpu)
    grad_rel = _grads_rel(g_gpu, g_cpu)
    # the updated parameters as one vector: Adam turns the key bias's
    # rounding-noise gradient into a step of ~lr * 1e-2 whose sign is the
    # noise's, so that parameter alone is not comparable relatively
    param_rel = _rel(torch.cat([p_gpu[n].flatten() for n in p_cpu]),
                     torch.cat([p.flatten() for p in p_cpu.values()]))
    print(f"train parity: fp32 GPT(D=64) one next_token_loss + AdamW step, "
          f"CUDA kernels vs CPU plain: loss {l_gpu:.6f} vs {l_cpu:.6f} (rel "
          f"{loss_rel:.3e}, tol 1e-5), worst gradient rel {grad_rel:.3e} "
          f"(tol 1e-4; zero gradients held to 1e-6 of the norm), updated "
          f"params rel {param_rel:.3e} (tol 1e-4); launches fwd/dkv/dq "
          f"{launched}")
    if launched != [cfg["depth"]] * 3:
        raise AssertionError("the CUDA train step did not run each flash "
                             "kernel once per layer")
    if not (loss_rel <= 1e-5 and grad_rel <= 1e-4 and param_rel <= 1e-4):
        raise AssertionError("the CUDA train step disagrees with the CPU")


#: kernel-name fragments (lower case) of each group in the train step's
#: profile; the first group that matches takes the kernel
KERNEL_GROUPS = (
    ("flash_fwd", ("flash_fwd",)),
    ("flash_bwd", ("dkv_", "dq_")),
    ("matmul", ("gemm", "sm90", "cutlass", "nvjet", "xmma")),
    ("optimizer", ("multi_tensor_apply",)),
    ("softmax_ce", ("softmax", "nll")),
    ("casts_copies", ("copy_kernel",)),
)


def _profile_train(step_fn, state, batches, dev, step_ms):
    """Device time of a few more train steps by kernel group, from
    torch.profiler, and the device's idle share: 1 - busy / `step_ms`,
    the unprofiled step time (the profiler slows the host)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for x in batches:
            state, metrics = step_fn(state, (x,))
            float(metrics["loss"])
        torch.cuda.synchronize(dev)
    wall_ms = (time.perf_counter() - t0) * 1e3 / len(batches)
    kernels = [(e.key, e.self_device_time_total / 1e3 / len(batches))
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0
               and not getattr(e, "is_user_annotation", False)]
    busy = sum(ms for _, ms in kernels)
    if not kernels:
        print("train profile: the profiler recorded no device time; busy "
              "share not measured")
        return
    groups = {name: 0.0 for name, _ in KERNEL_GROUPS}
    groups["other"] = 0.0
    for key, ms in kernels:
        name = next((g for g, frags in KERNEL_GROUPS
                     if any(f in key.lower() for f in frags)), "other")
        groups[name] += ms
    print(f"train profile ({len(batches)} steps, torch.profiler): device "
          f"busy {busy:.2f} ms a step; idle share {1 - busy / step_ms:.3f} "
          f"of the unprofiled {step_ms:.2f} ms step (profiled wall "
          f"{wall_ms:.2f} ms)")
    print("train profile: device ms a step by group "
          + json.dumps({k: round(v, 3) for k, v in groups.items()}))
    for key, ms in sorted(kernels, key=lambda kv: -kv[1])[:10]:
        print(f"train profile:   {ms:8.3f} ms  {key[:110]}")


def phase_train(fa, dev):
    from tfde_tpu_torch.data.datasets import synthetic_tokens
    from tfde_tpu_torch.models.gpt import GPT2Small, next_token_loss
    from tfde_tpu_torch.training.optimizers import (
        adamw, warmup_cosine_decay_schedule)
    from tfde_tpu_torch.training.step import init_state, make_custom_train_step

    steps, batch, seq, profiled = 20, 8, 1024, 3
    model = GPT2Small(vocab_size=50257, max_position=1024,
                      dtype=torch.bfloat16, device=dev, seed=0)
    tokens = synthetic_tokens(256, seq, vocab=model.vocab_size, seed=2)
    state = init_state(model, adamw(
        model, warmup_cosine_decay_schedule(0.0, 3e-4, 5, steps),
        weight_decay=0.1))
    step_fn = make_custom_train_step(next_token_loss, grad_accum=1)
    nrng = np.random.default_rng(0)
    batches = [torch.as_tensor(tokens[nrng.integers(0, len(tokens), batch)],
                               device=dev) for _ in range(steps + profiled)]
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    fa.flash_forward.launches = 0
    fa.flash_backward.dkv_launches = 0
    fa.flash_backward.dq_launches = 0
    losses, clock = [], [time.perf_counter()]
    for x in batches[:steps]:
        state, metrics = step_fn(state, (x,))
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize(dev)
        clock.append(time.perf_counter())
    launches = {"flash_fwd": fa.flash_forward.launches,
                "flash_bwd_dkv": fa.flash_backward.dkv_launches,
                "flash_bwd_dq": fa.flash_backward.dq_launches}
    step_s = [b - a for a, b in zip(clock, clock[1:])]
    mean_s = sum(step_s[2:]) / len(step_s[2:])
    print(f"train: GPT-2 small, fp32 master weights, bf16 compute, batch "
          f"{batch} x {seq} tokens, AdamW lr 3e-4 warmup 5 cosine {steps}, "
          f"wd 0.1: {steps} steps")
    print(f"train: losses {[round(x, 4) for x in losses]}")
    print(f"train: losses, full precision (identical run to run: no atomics) "
          f"{losses}")
    print(f"train: ms per step (mean of steps 3-{steps}) {mean_s * 1e3:.2f}, "
          f"first step {step_s[0] * 1e3:.1f} ms, {batch * seq / mean_s:.0f} "
          f"training tokens/s, max memory allocated "
          f"{torch.cuda.max_memory_allocated(dev) / 2 ** 30:.2f} GiB")
    print(f"train: launches {json.dumps(launches)} over {steps} steps x "
          f"{model.depth} layers")
    if any(n != model.depth * steps for n in launches.values()):
        raise AssertionError("the train path did not run each flash kernel "
                             "once per layer per step")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite training loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")
    _profile_train(step_fn, state, batches[steps:], dev, mean_s * 1e3)
    return launches


PHASES = ("kernels", "parity", "train_parity", "serve", "train")


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of %(default)s to run after "
                         "the device and build phases (an A/B of kernel and "
                         "train times); the kernels JSON line and the last "
                         "line print only when all run")
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    if set(phases) - set(PHASES):
        ap.error(f"unknown phases {sorted(set(phases) - set(PHASES))}")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from tfde_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t_start = time.perf_counter()
    phase_device()
    phase_build(fa)
    timing = phase_kernels(fa, dev) if "kernels" in phases else None
    if "parity" in phases:
        phase_parity(dev)
    if "train_parity" in phases:
        phase_train_parity(fa, dev)
    if "serve" in phases:
        phase_serve(fa, dev)
    launches = phase_train(fa, dev) if "train" in phases else None
    if len(phases) < len(PHASES):
        print(f"total {time.perf_counter() - t_start:.1f} s (phases "
              f"{','.join(phases)}; no result line)")
        return 1
    replaces = {"flash_fwd": ("flash_fwd.cu", 188),
                "flash_bwd_dkv": ("flash_bwd.cu", 606),
                "flash_bwd_dq": ("flash_bwd.cu", 683)}
    kernels = []
    for name, (source, line) in replaces.items():
        t = timing[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"tfde_tpu_torch/csrc/{source}",
            "replaces": f"tfde_tpu/ops/flash_attention.py:{line}",
            "launches": launches[name],
            "max_abs_err": t["max_abs_err"],
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
        })
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
