#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`tfde_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero
without printing a result:

1. device — the card's name and power limit from nvidia-smi;
2. build  — compile every kernel source of the serving and training paths
   (tfde_tpu_torch/csrc/flash_fwd.cu, flash_bwd.cu) with nvcc (sm_90a),
   one nvcc per source, all started together; count each bf16 kernel's
   wgmma (HGMMA), TMA (UTMALDG) and mma.sync (HMMA) instructions in
   `cuobjdump -sass` (the forward, dK/dV and dQ kernels must have wgmma
   and TMA and no mma.sync), and time one tensor-map encode on the host;
3. kernels — each kernel against its plain PyTorch version on the card,
   over the slice shape and the option matrix (the forward's out and lse;
   the backward pair's dq, dk and dv; at the slice shape and one GQA case
   two backward calls must give the same bits), then its time beside the
   plain version's, the library call's (SDPA's forward, SDPA's backward;
   timing only) and the bound; then the three bf16 kernels at D 128;
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
   loss must be finite and the last below the first;
8. dp     — data parallelism on a one-rank NCCL group: BatchNormCNN under
   MultiWorkerMirroredStrategy (DDP) on CUDA against the CPU for five
   sgd(0.05) steps, in fp32 and in fp64 (and whether fp32 card runs repeat
   their bits, with cuDNN's default algorithms and deterministic ones);
   the reference recipe (global batch 128, sgd(0.2,
   momentum 0.9), 300 steps of synthetic MNIST) with ms per step, images/s
   and memory, its loss below 0.1 and the 10000 test images, the last
   batch ragged and masked, at accuracy >= 0.95; on a machine with more
   than one card, one process a card on NCCL (parity against the CPU, the
   same bits on every rank, the recipe's ms per step and its scaling
   efficiency against the same worker as one rank on one card); then, the group destroyed, `python -m
   tfde_tpu_torch.mnist_multiworker --device cuda` as a user runs it
   (PlainCNN through `Dataset` -> `device_prefetch` -> `Estimator.train`,
   15 steps). It runs none of the flash kernels;
9. lifecycle — the Estimator on the card (`testing.recipe`): the dp
   recipe (BatchNormCNN at the reference widths, dropout 0.5, seed 0,
   `cudnn.deterministic`, global batch 128, sgd(0.2, momentum 0.9)) from
   `Dataset.from_tensor_slices(train).shuffle(60000, seed=0).repeat()
   .batch(128)` through `device_prefetch` (pinned staging, a copy stream)
   and `Estimator.train` to step 300 on a one-rank NCCL group, a
   checkpoint every 100: its ms per step over steps 11-100 beside the dp
   phase's old loop and the old loop again under `cudnn.deterministic`,
   the feed's blocking share of that window, the feed alone (inline, and
   with `background=True`, whose batches must equal the inline feed's),
   and the device's idle share over 20 steady steps of a resumed run;
   `Estimator.evaluate` of the 10000 test images in
   batches of 768 at accuracy >= 0.95; a checkpoint's bytes, save and
   restore ms; a child process (`python -m tfde_tpu_torch.testing`)
   that raises SIGTERM in itself after step 150 must die by the signal
   with its newest checkpoint at 150, and a run resuming it to 300 must
   end with every parameter and buffer of the uninterrupted run, bit for
   bit; `mnist_multiworker.main` with `--model-dir`, `--epochs 2` then
   3, must resume at step 10 and end at 15; GPT-2 small (bf16 compute)
   through the Estimator with `loss_fn`/`eval_fn`, 4 steps with a
   checkpoint every 2 and a fresh Estimator resuming to 6, must end with
   the bits of 6 uninterrupted steps, each run launching each flash
   kernel 12 times a step (counters zeroed just before each run). Every
   model_dir lies under build/ and is removed at the end;
10. export — the reference's two Estimator recipes and the serving export:
   `python -m tfde_tpu_torch.mnist_estimator --working-dir D --num-epochs
   1 --no-tensorboard` in a child process, as a user runs it (TF32 off
   through ``NVIDIA_TF32_OVERRIDE=0``; BatchNormCNN at the reference
   widths, batch 128, 468 steps under ParameterServerStrategy, at one
   process without a group), which must exit 0 with a checkpoint at 468,
   one artifact under D/export/exporter and a finite final eval; its ms
   per step from the logged steps/sec beside the dp phase's; the artifact
   served on the card (`load_serving`) at batch sizes 1, 7, 128 and 10000
   against the model restored from the checkpoint (softmax on the card)
   and against the same artifact served on the CPU, each within 1e-5, and
   its argmax accuracy over the 10000 test images against the final eval
   accuracy within 1e-4; the seconds and bytes of an export and the served
   and live ms of a batch of 128; `train_and_evaluate` with a
   BestExporter over the evals after steps 1 and 2 and the final one,
   whose newest artifact must be the one best_metric.json names;
   `python -m tfde_tpu_torch.mnist_tf2 --custom-loop --max-steps 100`,
   then `--model-dir D2 --max-steps 200`, each exiting 0 at its step
   count with a finite loss; a GPT whose forward launches the flash
   kernel must refuse to export (NotImplementedError after one probe
   launch); on a machine with two cards or more, ParameterServerStrategy
   one process a card on NCCL against the mirrored run (the same bits on
   every rank, each rank's optimizer-state bytes: 296,264 at four). It
   runs none of the flash kernels but the probe's. Every directory lies
   under build/ and is removed at the end.

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


def _card() -> str:
    """The first card's `nvidia-smi --query-gpu=name,power.limit` line."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return smi.stdout.strip().splitlines()[0]


def phase_device():
    print(_card())
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


#: the bf16 kernels, all redesigned for Hopper: each must have compiled to
#: wgmma (HGMMA) and TMA loads (UTMALDG), and to no mma.sync (HMMA)
HOPPER_KERNELS = ("flash_fwd_bf16_kernel", "dkv_bf16_kernel",
                  "dq_bf16_kernel")


def _check_sass(libs):
    """Count HGMMA, UTMALDG and HMMA instructions of each bf16 kernel in
    `cuobjdump -sass` of the built libraries; raise if one lacks wgmma or
    TMA, or still has an mma.sync."""
    from tfde_tpu_torch.utils.build import sass_counts

    seen = set()
    for lib in libs.values():
        for symbol, counts in sass_counts(
                lib.path, ("HGMMA", "UTMALDG", "HMMA", "STL", "LDL")).items():
            name = next((k for k in HOPPER_KERNELS if k in symbol), None)
            if name is None:
                continue
            d = 128 if "ILi128E" in symbol else 64
            print(f"sass: {name}<{d}>: HGMMA {counts['HGMMA']}, UTMALDG "
                  f"{counts['UTMALDG']}, HMMA {counts['HMMA']}, local-memory "
                  f"STL {counts['STL']} / LDL {counts['LDL']}")
            if not (counts["HGMMA"] and counts["UTMALDG"]) or counts["HMMA"]:
                raise AssertionError(f"{name}<{d}> compiled without wgmma or "
                                     f"TMA, or with mma.sync: {counts}")
            seen.add((name, d))
    want = {(k, d) for k in HOPPER_KERNELS for d in (64, 128)}
    if seen != want:
        raise AssertionError(f"the SASS check found {sorted(seen)}, not "
                             f"{sorted(want)}")


def _print_encode_time(fa):
    """Host time of one TMA tensor-map encode (each bf16 launch of the
    forward encodes 3, of dK/dV and of dQ 4)."""
    base = torch.empty(8 * 1024 * 12 * 64, dtype=torch.bfloat16,
                       device="cuda")
    fn = fa.build("flash_fwd.cu").lib.tfde_flash_tma_encode_ns
    fn(base.data_ptr(), 100)
    ns = fn(base.data_ptr(), 10000)
    print(f"build: one tensor-map encode takes {ns / 1e3:.2f} us on the host "
          f"(mean of 10000; 3 a forward launch, 4 a dK/dV or dQ launch)")


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
    # a window of one key (each row sees only itself) and a query group of
    # three, not a power of two
    ("window1_gqa3", 2, 300, 12, 4, 64, torch.bfloat16, True, 1, None, None),
]

#: the cases whose backward runs twice and must give the same bits (no
#: atomics, a fixed order of every sum)
DETERMINISM_CASES = ("slice", "gqa_window_cap_scale")

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
    # `_grads_rel`: a gradient that is zero in exact arithmetic (dq and dk
    # under a window of one key: P = 1 and dP = delta, so dS = 0) is held
    # to 1e-6 of the plain norms together, not compared relatively
    names = ("dq", "dk", "dv")
    worst = _grads_rel(dict(zip(names, got)), dict(zip(names, want)))
    ok = (all(g.shape == w.shape for g, w in zip(got, want))
          and all(bool(torch.isfinite(g).all()) for g in got)
          and worst <= tol
          and all(float(w.float().abs().max()) > 0 for w in want))
    norms = [float(w.float().norm()) for w in want]
    kernel_norms = [float(g.float().norm()) for g in got]
    print(f"kernel flash_bwd {name}: dq rel {rels[0]:.3e}, dk rel "
          f"{rels[1]:.3e}, dv rel {rels[2]:.3e} (tol {tol:g}; worst "
          f"{worst:.3e} with zero gradients held to 1e-6 of the norm); max "
          f"abs dq {errs[0]:.3e}, dk {errs[1]:.3e}, dv {errs[2]:.3e}; norms "
          f"plain {norms[0]:.3e}, {norms[1]:.3e}, {norms[2]:.3e}, kernel "
          f"{kernel_norms[0]:.3e}, {kernel_norms[1]:.3e}, "
          f"{kernel_norms[2]:.3e} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"the flash backward pair disagrees with its "
                             f"plain version on case {name}")
    if name in DETERMINISM_CASES:
        again = fa.flash_backward(q, k, v, out, lse, do, causal, window,
                                  scale, cap)
        same = [bool(torch.equal(a, g)) for a, g in zip(again, got)]
        print(f"kernel flash_bwd {name}: a second call gives the same dq, dk, "
              f"dv bits: {same}")
        if not all(same):
            raise AssertionError(f"the flash backward pair is not "
                                 f"deterministic on case {name}: {same}")
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
    """The three bf16 kernels at D 128 (8 x 1024 tokens, 6 heads, bf16,
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
    dq_ms = _time_ms(
        lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, True), dev)
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
    qb, qby = _bound(b, s, h, kv, d, torch.bfloat16, True, None, "dq")
    print(f"kernel D128 timing ({b} x {s}, {h} heads, D {d}, bf16, causal): "
          f"flash_fwd {fwd_ms:.4f} ms (bound {fb:.4f}, {fby}; SDPA forward "
          f"{sdpa_fwd:.4f}), flash_bwd_dkv {dkv_ms:.4f} ms (bound {db:.4f}, "
          f"{dby}), flash_bwd_dq {dq_ms:.4f} ms (bound {qb:.4f}, {qby}); "
          f"SDPA backward, whole {sdpa_bwd:.4f}")


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


def _profile_train(run, batches, dev, step_ms, label="train"):
    """Profile a few more train steps (`run(batch)` -> the step's loss
    tensor) with torch.profiler and print them (`_print_profile`)."""
    from tfde_tpu_torch.testing import profile_steps

    _print_profile(profile_steps(run, batches, dev), len(batches), step_ms,
                   label)


def _print_profile(prof, n, step_ms, label):
    """Device time a step by kernel group and the top kernels; the device's
    idle share, 1 - busy / `step_ms` (the unprofiled step time: the
    profiler slows the host); the top host operators by self time (the
    profiler inflates them; their order says where the host spends the
    step)."""
    kernels = prof["device"]
    if not kernels:
        print(f"{label} profile: the profiler recorded no device time; busy "
              "share not measured")
        return
    busy = sum(ms for _, ms in kernels)
    groups = {name: 0.0 for name, _ in KERNEL_GROUPS}
    groups["other"] = 0.0
    for key, ms in kernels:
        name = next((g for g, frags in KERNEL_GROUPS
                     if any(f in key.lower() for f in frags)), "other")
        groups[name] += ms
    print(f"{label} profile ({n} steps, torch.profiler): device busy "
          f"{busy:.2f} ms a step; idle share {1 - busy / step_ms:.3f} of the "
          f"unprofiled {step_ms:.2f} ms step (profiled wall "
          f"{prof['wall_ms']:.2f} ms)")
    print(f"{label} profile: device ms a step by group "
          + json.dumps({k: round(v, 3) for k, v in groups.items()}))
    for key, ms in sorted(kernels, key=lambda kv: -kv[1])[:10]:
        print(f"{label} profile:   {ms:8.3f} ms  {key[:110]}")
    for key, ms, calls in sorted(prof["host"], key=lambda kv: -kv[1])[:6]:
        print(f"{label} profile: host {ms:8.3f} ms a step, {calls} calls  "
              f"{key[:80]}")


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
    _profile_train(lambda x: step_fn(state, (x,))[1]["loss"],
                   batches[steps:], dev, mean_s * 1e3)
    return launches


#: dp parity: the CUDA run (DDP on a one-rank NCCL group, cuDNN, fp32 with
#: TF32 off) against the CPU run on the same weights and batches, five
#: sgd(0.05) steps of BatchNormCNN. With cuDNN's default algorithms (those
#: the recipe runs): the losses' max relative error, the final parameters
#: and running statistics as one vector (relative Frobenius error) and
#: their max abs error. Not tensor by tensor: the first BatchNorm's bias
#: (~2e-2) has a gradient that nearly cancels (the next BatchNorm removes
#: a shift of its input), and the default convolution backward
#: algorithms, whose bits change run to run, leave it ~4e-4 of itself from
#: an fp64 run in most runs, where the CPU and cuDNN's deterministic
#: algorithms leave it ~5e-7. Under `cudnn.deterministic` every tensor is held relatively
#: (`tensor_rel`), and so is every tensor of the same runs in fp64
#: (`fp64_rel`), where rounding is ~1e-16.
DP_TOL = {"loss": 1e-5, "params_rel": 1e-5, "params_abs": 1e-4,
          "tensor_rel": 1e-4, "fp64_rel": 1e-9}
#: dp training: the reference recipe (global batch 128, sgd(0.2, momentum
#: 0.9), dropout 0.5), timed over steps 10-100; the eval at step 100 is
#: printed only: the running statistics (momentum 0.99) still hold 0.99^100
#: = 37% of their initial values there, and the JAX package's own run of the
#: recipe evaluates at 0.44 (CPU). The accuracy is asserted after DP_STEPS.
DP_BATCH, DP_TIMED, DP_STEPS, DP_EVAL_BATCH = 128, (10, 100), 300, 768
#: dp: steps profiled after the run (torch.profiler), for the idle share
DP_PROFILED = 20


def _dp_eval(strategy, state, images, labels):
    """(accuracy, mean loss, weight) of a whole-set pass of `make_eval_step`
    in batches of DP_EVAL_BATCH, each padded by `pad_batch_for_mesh` to
    that size: the last (10000 = 13 x 768 + 16) is ragged on purpose."""
    from tfde_tpu_torch.training.step import make_eval_step, pad_batch_for_mesh

    if DP_EVAL_BATCH % strategy.batch_divisor:
        raise AssertionError("the eval batch does not divide by the mesh")
    step = make_eval_step(strategy, state)
    sums = {"loss_sum": 0.0, "correct_sum": 0.0, "weight": 0.0}
    for i in range(0, len(images), DP_EVAL_BATCH):
        batch = pad_batch_for_mesh((images[i:i + DP_EVAL_BATCH],
                                    labels[i:i + DP_EVAL_BATCH]),
                                   DP_EVAL_BATCH)
        for k, v in step(state, batch).items():
            sums[k] += float(v)
    w = sums["weight"]
    return sums["correct_sum"] / w, sums["loss_sum"] / w, w


def _dp_parity(dev, images, labels):
    """BatchNormCNN, five sgd(0.05) steps on the same weights and batches:
    DDP on the one-rank NCCL group (CUDA) against no group (CPU), in fp32
    (with cuDNN's default algorithms three times, under
    `cudnn.deterministic` twice) and in fp64, held to DP_TOL; printed too:
    whether the repeated card runs give the same bits, and how far each
    fp32 run lies from the CPU's fp64 run. Returns the CPU fp32 run, for
    `_dp_cards`."""
    from tfde_tpu_torch.models.cnn import BatchNormCNN
    from tfde_tpu_torch.parallel.strategies import MultiWorkerMirroredStrategy
    from tfde_tpu_torch.runtime.mesh import LocalMesh
    from tfde_tpu_torch.training.optimizers import sgd
    from tfde_tpu_torch.training.step import init_state, make_train_step

    batches = [(images[i * 64:(i + 1) * 64], labels[i * 64:(i + 1) * 64])
               for i in range(5)]
    initial = BatchNormCNN(dropout_rate=0.0, device="cpu", seed=0).state_dict()
    cuda_strategy = MultiWorkerMirroredStrategy()
    if torch.distributed.get_backend(cuda_strategy.data_group) != "nccl":
        raise AssertionError("the CUDA run is not on the NCCL group")
    cpu_strategy = MultiWorkerMirroredStrategy(mesh=LocalMesh(("data",)))

    def run(device, dtype, strategy, deterministic=False):
        model = BatchNormCNN(dropout_rate=0.0, device=device, seed=0)
        model.load_state_dict(initial)
        model.to(dtype)
        state = init_state(model, sgd(model, 0.05))
        step = make_train_step(strategy, state)
        torch.backends.cudnn.deterministic = deterministic
        try:
            losses = [float(step(state, b)[1]["loss"]) for b in batches]
        finally:
            torch.backends.cudnn.deterministic = False
        return losses, {k: v.detach().cpu() for k, v in
                        model.state_dict().items()}

    l_cpu, p_cpu = run("cpu", torch.float32, cpu_strategy)
    l_64, p_64 = run("cpu", torch.float64, cpu_strategy)
    default = [run(dev, torch.float32, cuda_strategy) for _ in range(3)]
    determ = [run(dev, torch.float32, cuda_strategy, True) for _ in range(2)]
    l_cuda64, p_cuda64 = run(dev, torch.float64, cuda_strategy)

    def worst(params, ref):
        errs = {k: _rel(params[k], v) for k, v in ref.items()}
        k = max(errs, key=errs.get)
        return f"{errs[k]:.3e} ({k})", errs[k]

    def same(runs):
        return all(all(torch.equal(p[k], v) for k, v in runs[0][1].items())
                   for _, p in runs[1:])

    def loss_rel(losses, ref):
        return max(abs(a - b) / abs(b) for a, b in zip(losses, ref))

    what = (f"{cuda_strategy.describe()} as DDP on NCCL (CUDA) vs no group "
            f"(CPU)")
    _dp_compare(what, *default[0], l_cpu, p_cpu)
    det_loss = loss_rel(determ[0][0], l_cpu)
    det_text, det_err = worst(determ[0][1], p_cpu)
    print(f"dp parity, run to run on the card (fp32): same bits in 3 runs "
          f"with cuDNN's default algorithms: {same(default)}, in 2 with "
          f"cudnn.deterministic: {same(determ)}; worst single tensor rel vs "
          f"the CPU's fp32 run: default "
          f"{[worst(p, p_cpu)[0] for _, p in default]}, deterministic "
          f"{[worst(p, p_cpu)[0] for _, p in determ]} (tol "
          f"{DP_TOL['tensor_rel']:g}; losses max rel {det_loss:.3e})")
    if not (det_err <= DP_TOL["tensor_rel"] and det_loss <= DP_TOL["loss"]):
        raise AssertionError(f"the fp32 run under cudnn.deterministic "
                             f"({what}) disagrees with the CPU run: "
                             f"{det_text}")
    print(f"dp parity, distance from the CPU's fp64 run (worst single tensor "
          f"rel): CPU fp32 {worst(p_cpu, p_64)[0]}; card fp32 default "
          f"{[worst(p, p_64)[0] for _, p in default]}, deterministic "
          f"{[worst(p, p_64)[0] for _, p in determ]}")
    loss64 = loss_rel(l_cuda64, l_64)
    text, err64 = worst(p_cuda64, p_64)
    print(f"dp parity fp64: {what}: losses max rel {loss64:.3e}, worst single "
          f"tensor rel {text} (tol {DP_TOL['fp64_rel']:g})")
    if not (loss64 <= DP_TOL["fp64_rel"] and err64 <= DP_TOL["fp64_rel"]):
        raise AssertionError(f"the fp64 data-parallel run ({what}) disagrees "
                             f"with the CPU run")
    return ({k: v.numpy() for k, v in initial.items()}, batches, l_cpu,
            p_cpu)


def _dp_compare(what, losses, params, l_cpu, p_cpu):
    """Hold a run's losses and final parameters and statistics to the CPU
    run's under DP_TOL; print the errors."""
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, l_cpu))
    vec_rel = _rel(torch.cat([params[k].flatten() for k in p_cpu]),
                   torch.cat([v.flatten() for v in p_cpu.values()]))
    abs_err = {k: float((params[k] - v).abs().max()) for k, v in p_cpu.items()}
    worst = max(abs_err, key=abs_err.get)
    print(f"dp parity: BatchNormCNN, 5 sgd(0.05) steps of 64, fp32, {what}: "
          f"losses {[round(x, 6) for x in losses]} vs "
          f"{[round(x, 6) for x in l_cpu]}, max rel {loss_rel:.3e} (tol "
          f"{DP_TOL['loss']:g}); parameters and statistics as one vector rel "
          f"{vec_rel:.3e} (tol {DP_TOL['params_rel']:g}), max abs "
          f"{abs_err[worst]:.3e} ({worst}; tol {DP_TOL['params_abs']:g}); "
          f"worst single-tensor rel "
          f"{max(_rel(params[k], v) for k, v in p_cpu.items()):.3e}")
    if not (loss_rel <= DP_TOL["loss"] and vec_rel <= DP_TOL["params_rel"]
            and abs_err[worst] <= DP_TOL["params_abs"]):
        raise AssertionError(f"the data-parallel run ({what}) disagrees with "
                             f"the CPU run")


def _dp_train(dev, train, test):
    from tfde_tpu_torch.mnist_multiworker import global_batches
    from tfde_tpu_torch.models.cnn import BatchNormCNN
    from tfde_tpu_torch.parallel.strategies import MultiWorkerMirroredStrategy
    from tfde_tpu_torch.training.optimizers import sgd
    from tfde_tpu_torch.training.step import init_state, make_train_step

    model = BatchNormCNN(device=dev, seed=0)
    state = init_state(model, sgd(model, 0.2, momentum=0.9))
    strategy = MultiWorkerMirroredStrategy()
    step = make_train_step(strategy, state)
    generator = torch.Generator(device=dev).manual_seed(0)
    batches = list(global_batches(*train, DP_BATCH, DP_STEPS))
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    losses, clock = [], {}
    for i, batch in enumerate(batches):
        if i in DP_TIMED:
            torch.cuda.synchronize(dev)
            clock[i] = time.perf_counter()
        if i == DP_TIMED[1]:
            acc100, loss100, _ = _dp_eval(strategy, state, *test)
        state, metrics = step(state, batch, generator)
        losses.append(metrics["loss"])
    losses = [float(x) for x in losses]
    ms = (clock[DP_TIMED[1]] - clock[DP_TIMED[0]]) * 1e3 / (
        DP_TIMED[1] - DP_TIMED[0])
    acc, eval_loss, weight = _dp_eval(strategy, state, *test)
    _profile_train(lambda b: step(state, b, generator)[1]["loss"],
                   batches[:DP_PROFILED], dev, ms, label="dp")
    print(f"dp train: BatchNormCNN (dropout 0.5), {strategy.describe()} as "
          f"DDP on NCCL, global batch {DP_BATCH}, sgd(0.2, momentum=0.9), "
          f"{DP_STEPS} steps; losses at steps 1, 10, 100, {DP_STEPS}: "
          f"{losses[0]:.4f}, {losses[9]:.4f}, {losses[99]:.4f}, "
          f"{losses[-1]:.4f}")
    print(f"dp train: {ms:.3f} ms per step (mean of steps "
          f"{DP_TIMED[0] + 1}-{DP_TIMED[1]}, host clock after a synchronise), "
          f"{DP_BATCH / ms * 1e3:.0f} images/s, max memory allocated "
          f"{torch.cuda.max_memory_allocated(dev) / 2 ** 20:.1f} MiB, on "
          f"{_card()}")
    print(f"dp eval: {int(weight)} test images in batches of "
          f"{DP_EVAL_BATCH} (the last padded from {len(test[0]) % DP_EVAL_BATCH}"
          f" and masked): accuracy {acc:.4f} (>= 0.95), loss {eval_loss:.4f}; "
          f"at step 100 (printed only): accuracy {acc100:.4f}, loss "
          f"{loss100:.4f}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite training loss: {losses}")
    if not losses[-1] < 0.1:
        raise AssertionError(f"the loss ends at {losses[-1]}, not below 0.1")
    if weight != len(test[0]) or not acc >= 0.95:
        raise AssertionError(f"eval over {weight} images: accuracy {acc}")
    return ms


def _dp_cards(parity_ref):
    """Across every card of the machine, one process a card on an NCCL
    group (`testing.dp_ranks_worker`): the parity run split over the cards
    against the CPU run, the same bits on every rank, and the recipe at
    DP_BATCH a card, timed over steps 11-100 (the slowest rank's clock),
    with its scaling efficiency against the same worker run as one rank on
    one card just before (the same process setup on both sides)."""
    from tfde_tpu_torch.testing import dp_ranks_worker, run_ranks

    n = torch.cuda.device_count()
    if n < 2:
        print(f"dp cards: {n} card on this machine; the run across cards "
              f"needs two or more (not run)")
        return
    initial, batches, l_cpu, p_cpu = parity_ref

    def ranks(world, profiled):
        store = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "build", f"dp_store_{os.getpid()}_{world}")
        os.makedirs(os.path.dirname(store), exist_ok=True)
        try:
            return run_ranks(dp_ranks_worker, [
                (world, store, "cuda", ("BatchNormCNN", initial, batches,
                                        0.05),
                 DP_BATCH, DP_TIMED[1], DP_TIMED[0], profiled)] * world,
                timeout=600)
        finally:
            if os.path.exists(store):
                os.remove(store)

    one_ms = ranks(1, 0)[0]["ms"]
    out = ranks(n, DP_PROFILED)
    for r, o in enumerate(out):
        if (o["backend"], o["device"]) != ("nccl", f"cuda:{r}"):
            raise AssertionError(f"rank {r} ran on {o['backend']}, {o['device']}")
    first = out[0]["parity"]
    same = all(np.array_equal(v, o["parity"]["state_dict"][k])
               for o in out[1:] for k, v in first["state_dict"].items())
    ms = max(o["ms"] for o in out)
    rate, one = DP_BATCH * n / ms * 1e3, DP_BATCH / one_ms * 1e3
    losses = out[0]["losses"]
    print(f"dp cards: the same parameter bits on all {n} ranks: {same}")
    print(f"dp cards: recipe at {DP_BATCH} a card (global {DP_BATCH * n}), "
          f"{DP_TIMED[1]} steps: losses at steps 1, 10, {DP_TIMED[1]}: "
          f"{losses[0]:.4f}, {losses[9]:.4f}, {losses[-1]:.4f}; {ms:.3f} ms "
          f"per step (slowest rank; per rank "
          f"{[round(o['ms'], 3) for o in out]}), {rate:.0f} images/s, scaling "
          f"efficiency {rate / (n * one):.3f} against the same worker as "
          f"one rank on one card ({one_ms:.3f} ms per step, {one:.0f} "
          f"images/s), on {n} x {_card()}")
    _print_profile(out[0]["profile"], DP_PROFILED, ms, "dp cards rank 0")
    _dp_compare(f"DDP over {n} cards on NCCL ({64 // n} rows a card) vs the CPU",
                [h["loss"] for h in first["history"]],
                {k: torch.as_tensor(v) for k, v in first["state_dict"].items()},
                l_cpu, p_cpu)
    if not same:
        raise AssertionError("the ranks' parameters differ")
    if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]):
        raise AssertionError(f"the loss across cards did not fall: {losses}")


def phase_dp(dev):
    """The data-parallel slice on the card: a one-rank NCCL group (NCCL
    refuses two ranks on one card; on one card every multi-rank check is a
    gloo test on the CPU), BatchNormCNN under MultiWorkerMirroredStrategy
    (DDP) against the CPU, the reference recipe trained and evaluated; the
    group destroyed, the same across every card where the machine has
    more than one (`_dp_cards`); then `mnist_multiworker.main` run as a
    user would (its `bootstrap()` at world size 1). Returns the recipe's
    ms per step through the old loop, which the lifecycle phase prints
    beside the Estimator's."""
    import torch.distributed as dist

    from tfde_tpu_torch import mnist_multiworker
    from tfde_tpu_torch.data import datasets

    train, test = datasets.mnist(flatten=True)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        parity_ref = _dp_parity(dev, *train)
        ms = _dp_train(dev, train, test)
    finally:
        dist.destroy_process_group()
    _dp_cards(parity_ref)
    t0 = time.perf_counter()
    state, metrics = mnist_multiworker.main(["--device", "cuda"])
    print(f"dp entry point: mnist_multiworker.main(['--device', 'cuda']): "
          f"{state.step} steps of PlainCNN through the Estimator, last "
          f"{json.dumps(metrics)} in {time.perf_counter() - t0:.1f} s")
    if state.step != 15 or not math.isfinite(metrics["loss"]):
        raise AssertionError(f"the entry point ended at step {state.step} "
                             f"with {metrics}")
    return ms


#: lifecycle: the recipe's steps, checkpoint interval, and the step after
#: which the child process interrupts itself
LC_STEPS, LC_SAVE, LC_KILL = 300, 100, 150
#: lifecycle: steps of the resumed run before its profiled window
LC_WARM = 5
#: lifecycle GPT: steps of the interrupted run, of the whole run, and the
#: checkpoint interval
LC_GPT_FIRST, LC_GPT_STEPS, LC_GPT_SAVE = 4, 6, 2


def _lc_old_loop_ms(dev, train):
    """ms per step of the dp phase's old loop (`global_batches` +
    `make_train_step`, the batch copied in the step) over steps 11-100,
    under the cuDNN settings in force."""
    from tfde_tpu_torch.mnist_multiworker import global_batches
    from tfde_tpu_torch.models.cnn import BatchNormCNN
    from tfde_tpu_torch.parallel.strategies import MultiWorkerMirroredStrategy
    from tfde_tpu_torch.training.optimizers import sgd
    from tfde_tpu_torch.training.step import init_state, make_train_step

    model = BatchNormCNN(device=dev, seed=0)
    state = init_state(model, sgd(model, 0.2, momentum=0.9))
    step = make_train_step(MultiWorkerMirroredStrategy(), state)
    generator = torch.Generator(device=dev).manual_seed(0)
    for i, batch in enumerate(global_batches(*train, DP_BATCH, DP_TIMED[1])):
        if i == DP_TIMED[0]:
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
        step(state, batch, generator)
    torch.cuda.synchronize(dev)
    return (time.perf_counter() - t0) * 1e3 / (DP_TIMED[1] - DP_TIMED[0])


def _lc_feed(dev, train, background):
    """`device_prefetch` alone (inline or with its worker thread) over the
    recipe's pipeline, nothing else running."""
    from tfde_tpu_torch.data import Dataset, device_prefetch
    from tfde_tpu_torch.parallel.strategies import MultiWorkerMirroredStrategy

    ds = (Dataset.from_tensor_slices(train).shuffle(len(train[0]), seed=0)
          .repeat().batch(DP_BATCH, drop_remainder=True))
    return device_prefetch(iter(ds), MultiWorkerMirroredStrategy(), dev,
                           background=background)


def _lc_feed_ms(dev, train, background=False):
    """ms per batch of the feed alone (`_lc_feed`: the host pull, the
    staging copy, the copy to the card) over batches 11-100."""
    feed = _lc_feed(dev, train, background)
    for i, _ in enumerate(feed):
        if i == DP_TIMED[0]:
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
        if i == DP_TIMED[1]:
            break
    torch.cuda.synchronize(dev)
    feed.close()
    return (time.perf_counter() - t0) * 1e3 / (DP_TIMED[1] - DP_TIMED[0])


def _lc_background_feed(dev, train):
    """The feed's background mode on the card: its first DP_TIMED[1]
    batches equal the inline feed's bit for bit. Returns (batches
    compared, its ms per batch over batches 11-100)."""
    inline, worker = _lc_feed(dev, train, False), _lc_feed(dev, train, True)
    n = 0
    for a, b in zip(inline, worker):
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            raise AssertionError(f"the background feed's batch {n} differs "
                                 f"from the inline feed's")
        n += 1
        if n == DP_TIMED[1]:
            break
    inline.close()
    worker.close()
    return n, _lc_feed_ms(dev, train, background=True)


def _lc_recipe(dev, root, dp_ms):
    """The recipe through the Estimator to LC_STEPS (run A): ms per step and
    the feed's blocking share over steps 11-100 beside the old loop's
    (the dp phase's, and again here under cudnn.deterministic) and the
    feed's alone, the eval, a checkpoint's bytes and save and restore
    times, the idle share of DP_PROFILED more steps. Returns A's
    parameters and buffers at LC_STEPS, on the host."""
    from tfde_tpu_torch import testing
    from tfde_tpu_torch.checkpoint.manager import STATE_FILE, CheckpointManager
    from tfde_tpu_torch.data import Dataset, datasets
    from tfde_tpu_torch.models.cnn import BatchNormCNN
    from tfde_tpu_torch.training.optimizers import sgd
    from tfde_tpu_torch.training.step import init_state

    est, input_fn, start = testing.recipe(os.path.join(root, "a"), dev,
                                          batch=DP_BATCH, save_every=LC_SAVE)
    if start != 0:
        raise AssertionError(f"run A found a checkpoint at step {start}")
    clock, wait = {}, {}

    def hook(state, step):
        if step in DP_TIMED:
            torch.cuda.synchronize(dev)
            clock[step] = time.perf_counter()
            wait[step] = est.feed.wait_seconds

    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    state = est.train(input_fn, LC_STEPS, _eval_hook=hook)
    wall = time.perf_counter() - t0
    a_params = {k: v.detach().cpu().clone()
                for k, v in est.model.state_dict().items()}
    loss = float(est.metrics["loss"])
    window = clock[DP_TIMED[1]] - clock[DP_TIMED[0]]
    ms = window * 1e3 / (DP_TIMED[1] - DP_TIMED[0])
    blocked = wait[DP_TIMED[1]] - wait[DP_TIMED[0]]
    train, (ex, ey) = datasets.mnist(flatten=True)
    old_det = _lc_old_loop_ms(dev, train)
    feed_ms = _lc_feed_ms(dev, train)
    compared, worker_ms = _lc_background_feed(dev, train)
    m = est.evaluate(lambda: Dataset.from_tensor_slices((ex, ey))
                     .batch(DP_EVAL_BATCH))
    old = "not run in this call" if dp_ms is None else f"{dp_ms:.3f} ms"
    print(f"lifecycle recipe: BatchNormCNN (dropout 0.5), global batch "
          f"{DP_BATCH}, sgd(0.2, momentum=0.9), cudnn.deterministic, Dataset "
          f"-> device_prefetch -> Estimator.train to step {state.step} on a "
          f"one-rank NCCL group ({wall:.1f} s, checkpoints every {LC_SAVE}); "
          f"last loss {loss:.4f}; max memory allocated "
          f"{torch.cuda.max_memory_allocated(dev) / 2 ** 20:.1f} MiB")
    print(f"lifecycle recipe: {ms:.3f} ms per step (mean of steps "
          f"{DP_TIMED[0] + 1}-{DP_TIMED[1]}, host clock after a synchronise; "
          f"the window holds step {DP_TIMED[1]}'s summary and checkpoint), "
          f"{DP_BATCH / ms * 1e3:.0f} images/s; the old loop (global_batches, "
          f"pageable copies in the step): {old} in the dp phase (cuDNN's "
          f"default algorithms), {old_det:.3f} ms here under "
          f"cudnn.deterministic; the feed's blocking share "
          f"{blocked / window:.4f} ({blocked * 1e3:.2f} ms of "
          f"{window * 1e3:.1f}); the feed alone {feed_ms:.3f} ms a batch "
          f"inline, {worker_ms:.3f} with background=True (its first "
          f"{compared} batches equal the inline feed's bit for bit); on "
          f"{_card()}")
    print(f"lifecycle eval: Estimator.evaluate over {len(ex)} test images in "
          f"batches of {DP_EVAL_BATCH} (the last {len(ex) % DP_EVAL_BATCH}): "
          f"{json.dumps(m)} (accuracy >= 0.95)")
    if not (math.isfinite(loss) and loss < 0.1):
        raise AssertionError(f"the Estimator's recipe ends at loss {loss}")
    if not m["accuracy"] >= 0.95:
        raise AssertionError(f"the Estimator's eval: {m}")

    # one checkpoint of the trained state: bytes, save (async: the part on
    # the loop, then the commit), restore into a fresh model
    mngr = CheckpointManager(os.path.join(root, "timing"))
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    mngr.save(state)
    t1 = time.perf_counter()
    mngr.wait()
    t2 = time.perf_counter()
    path = os.path.join(root, "timing", str(state.step), STATE_FILE)
    model = BatchNormCNN(device=dev, seed=1)
    fresh = init_state(model, sgd(model, 0.2, momentum=0.9))
    t3 = time.perf_counter()
    CheckpointManager(os.path.join(root, "timing")).restore_latest(fresh)
    torch.cuda.synchronize(dev)
    t4 = time.perf_counter()
    same = all(torch.equal(v.cpu(), a_params[k])
               for k, v in model.state_dict().items())
    print(f"lifecycle checkpoint: {os.path.getsize(path)} bytes (parameters, "
          f"BatchNorm statistics, momentum, step); save {(t1 - t0) * 1e3:.2f} "
          f"ms on the loop (copy to host) + {(t2 - t1) * 1e3:.2f} ms to the "
          f"commit; restore {(t4 - t3) * 1e3:.2f} ms; restored bits equal: "
          f"{same}, on {_card()}")
    if not same or fresh.step != state.step:
        raise AssertionError("the restored checkpoint differs from the state")

    # the idle share of DP_PROFILED steady steps: the profiler runs from
    # the hook after step LC_STEPS + LC_WARM to the hook after the last of
    # them, so the feed's start, the first step and the final save fall
    # outside it
    from torch.profiler import ProfilerActivity, profile

    from tfde_tpu_torch.testing import profile_summary

    first = LC_STEPS + LC_WARM
    last = first + DP_PROFILED
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    marks = {}

    def window(state, step):
        if step in (first, last):
            torch.cuda.synchronize(dev)
            marks[step] = time.perf_counter()
            if step == first:
                prof.start()
            else:
                prof.stop()

    est.train(input_fn, last, _eval_hook=window)
    prof = profile_summary(prof, DP_PROFILED,
                           (marks[last] - marks[first]) * 1e3 / DP_PROFILED)
    _print_profile(prof, DP_PROFILED, ms, "lifecycle")
    est.close()
    return a_params


def _lc_resume(dev, root, a_params):
    """Run B, a child process interrupted by its own SIGTERM after step
    LC_KILL; run C resumes B's model_dir to LC_STEPS here and must end
    with run A's bits."""
    from tfde_tpu_torch import testing
    from tfde_tpu_torch.checkpoint.manager import CheckpointManager

    dir_b = os.path.join(root, "b")
    env = dict(os.environ)
    here = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = here + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "tfde_tpu_torch.testing", dir_b,
         os.path.join(root, "b.json"), "--device", "cuda", "--max-steps",
         str(LC_STEPS), "--batch", str(DP_BATCH), "--save-every",
         str(LC_SAVE), "--kill-after", str(LC_KILL)],
        env=env, capture_output=True, text=True, timeout=600)
    steps = CheckpointManager(os.path.join(dir_b, "checkpoints")).all_steps()
    print(f"lifecycle resume: run B (child process, SIGTERM to itself after "
          f"step {LC_KILL}) exit code {proc.returncode} in "
          f"{time.perf_counter() - t0:.1f} s, checkpoints {steps}; "
          f"{proc.stderr.strip().splitlines()[-1] if proc.stderr else ''}")
    if proc.returncode != -15 or steps[-1:] != [LC_KILL]:
        raise AssertionError(f"run B: exit code {proc.returncode}, "
                             f"checkpoints {steps}:\n{proc.stderr[-3000:]}")
    est, input_fn, start = testing.recipe(dir_b, dev, batch=DP_BATCH,
                                          save_every=LC_SAVE)
    state = est.train(input_fn, LC_STEPS)
    est.close()
    c_params = est.model.state_dict()
    differ = [k for k, v in a_params.items()
              if not torch.equal(c_params[k].cpu(), v)]
    print(f"lifecycle resume: run C resumed at step {start} and ended at "
          f"{state.step}: {len(a_params) - len(differ)} of {len(a_params)} "
          f"parameters and buffers equal to run A's bit for bit (dropout "
          f"0.5 on)")
    if start != LC_KILL or state.step != LC_STEPS or differ:
        raise AssertionError(f"run C (from step {start}) differs from run A "
                             f"in {differ}")


def _lc_entry_point(root):
    """`mnist_multiworker.main` with --model-dir, twice: the second run must
    resume at step 10, end at 15, and say so in its log."""
    import logging

    from tfde_tpu_torch import mnist_multiworker

    d = os.path.join(root, "entry")
    records = []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    handler = Keep(logging.INFO)
    lc_log = logging.getLogger("tfde_tpu_torch.training.lifecycle")
    lc_log.addHandler(handler)
    level = lc_log.level
    lc_log.setLevel(logging.INFO)
    try:
        argv = ["--device", "cuda", "--model-dir", d]
        first, _ = mnist_multiworker.main(argv + ["--epochs", "2"])
        del records[:]
        second, metrics = mnist_multiworker.main(argv + ["--epochs", "3"])
    finally:
        lc_log.removeHandler(handler)
        lc_log.setLevel(level)
    resumed = [r for r in records if r.startswith("resuming at step")]
    print(f"lifecycle entry point: mnist_multiworker.main({argv} + "
          f"['--epochs', '2']) ended at step {first.step}; with --epochs 3: "
          f"{resumed}, ended at step {second.step}, last "
          f"{json.dumps(metrics)}")
    if (first.step, second.step) != (10, 15) or not resumed or not (
            resumed[0].startswith("resuming at step 10 of 15")):
        raise AssertionError(f"the entry point did not resume: {records}")


def _lc_gpt(fa, dev, root):
    """GPT-2 small through the Estimator with loss_fn/eval_fn: LC_GPT_FIRST
    steps with a checkpoint every LC_GPT_SAVE, a fresh Estimator resuming
    to LC_GPT_STEPS, against LC_GPT_STEPS uninterrupted steps; each run's
    flash launches counted from zero."""
    import itertools

    from tfde_tpu_torch.data import Dataset
    from tfde_tpu_torch.data.datasets import synthetic_tokens
    from tfde_tpu_torch.models.gpt import GPT2Small, next_token_loss
    from tfde_tpu_torch.training import Estimator, RunConfig
    from tfde_tpu_torch.training.optimizers import (
        adamw, warmup_cosine_decay_schedule)

    tokens = synthetic_tokens(64, 1024, vocab=50257, seed=2)
    ds = (Dataset.from_tensor_slices((tokens,)).shuffle(64, seed=0).repeat()
          .batch(8, drop_remainder=True))

    def eval_fn(model, batch, generator):
        loss, metrics = next_token_loss(model, batch, generator)
        return {"loss": loss, **metrics}

    def run(model_dir, steps, skip=0):
        model = GPT2Small(vocab_size=50257, max_position=1024,
                          dtype=torch.bfloat16, device=dev, seed=0)
        tx = adamw(model, warmup_cosine_decay_schedule(0.0, 3e-4, 2,
                                                       LC_GPT_STEPS),
                   weight_decay=0.1)
        est = Estimator(model, tx, config=RunConfig(
            model_dir=model_dir, save_checkpoints_steps=LC_GPT_SAVE,
            keep_checkpoint_max=1), loss_fn=next_token_loss, eval_fn=eval_fn)
        fa.flash_forward.launches = 0
        fa.flash_backward.dkv_launches = 0
        fa.flash_backward.dq_launches = 0
        t0 = time.perf_counter()
        state = est.train(lambda: itertools.islice(iter(ds), skip, None),
                          steps)
        torch.cuda.synchronize(dev)
        launches = (fa.flash_forward.launches, fa.flash_backward.dkv_launches,
                    fa.flash_backward.dq_launches)
        return est, state, launches, time.perf_counter() - t0

    whole, state, launches, secs = run(None, LC_GPT_STEPS)
    want = {k: v.detach().cpu() for k, v in whole.model.state_dict().items()}
    m = whole.evaluate(lambda: Dataset.from_tensor_slices((tokens[:16],))
                       .batch(8))
    whole.close()
    del whole
    checks = [(LC_GPT_STEPS, state.step, launches)]
    print(f"lifecycle gpt: GPT-2 small, bf16 compute, batch 8 x 1024, AdamW: "
          f"{state.step} uninterrupted steps through the Estimator in "
          f"{secs:.1f} s, launches fwd/dkv/dq {launches}; eval {json.dumps(m)}")
    d = os.path.join(root, "gpt")
    first, state, launches, secs = run(d, LC_GPT_FIRST)
    first.close()
    del first
    checks.append((LC_GPT_FIRST, state.step, launches))
    ckpt = os.path.join(d, "checkpoints", str(LC_GPT_FIRST), "state.pt")
    size = os.path.getsize(ckpt)
    resumed, state, launches, secs2 = run(d, LC_GPT_STEPS, LC_GPT_FIRST)
    resumed.close()
    checks.append((LC_GPT_STEPS - LC_GPT_FIRST, state.step - LC_GPT_FIRST,
                   launches))
    got = resumed.model.state_dict()
    differ = [k for k, v in want.items() if not torch.equal(got[k].cpu(), v)]
    print(f"lifecycle gpt: {LC_GPT_FIRST} steps with a checkpoint every "
          f"{LC_GPT_SAVE} ({size} bytes each) in {secs:.1f} s, then a fresh "
          f"Estimator resumed to {state.step} in {secs2:.1f} s, launches "
          f"fwd/dkv/dq {launches}: {len(want) - len(differ)} of {len(want)} "
          f"parameters equal to the uninterrupted run's bit for bit")
    del resumed
    for steps, ran, counts in checks:
        if ran != steps or counts != (12 * steps,) * 3:
            raise AssertionError(f"a GPT run of {steps} steps ran {ran} with "
                                 f"launches {counts}, not 12 a step")
    if differ or not math.isfinite(m["loss"]):
        raise AssertionError(f"the resumed GPT run differs in {differ} "
                             f"(eval {m})")


def phase_lifecycle(fa, dev, dp_ms=None):
    """The Estimator lifecycle on the card (docstring, phase 9): the recipe
    and its resume on a one-rank NCCL group under cudnn.deterministic,
    then the entry point and GPT-2 small with no group. Every model_dir
    lies under build/ and is removed at the end."""
    import shutil

    import torch.distributed as dist

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        f"lifecycle_{os.getpid()}")
    shutil.rmtree(root, ignore_errors=True)
    try:
        torch.backends.cudnn.deterministic = True
        dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                                world_size=1)
        try:
            a_params = _lc_recipe(dev, root, dp_ms)
            _lc_resume(dev, root, a_params)
        finally:
            dist.destroy_process_group()
            torch.backends.cudnn.deterministic = False
        _lc_entry_point(root)
        _lc_gpt(fa, dev, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)


#: export: the batch sizes the served artifact must answer, its tolerance
#: against the restored model on the card (TF32 off) and against its own
#: serving on the CPU, and against the Estimator's final eval accuracy
EX_BATCHES, EX_TOL, EX_ACC_TOL = (1, 7, 128, 10000), 1e-5, 1e-4
#: export across cards: each rank's optimizer-state bytes at four ranks
#: (BatchNormCNN, momentum SGD, fp32): a quarter of Dense_0's weight
#: (58,800 of its 235,200 elements) and the 15,266 replicated elements
EX_PS_BYTES = {4: 4 * (58_800 + 15_266)}


def _ex_child(argv, root, what):
    """`python -m <argv>` in a child process from this checkout, with TF32
    off (``NVIDIA_TF32_OVERRIDE=0``: torch's default runs cuDNN's
    convolutions in TF32, and the child's eval accuracy is held to the
    artifact's in fp32): (its stderr log, seconds); raises unless it
    exits 0."""
    env = dict(os.environ, NVIDIA_TF32_OVERRIDE="0")
    here = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = here + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", *argv], env=env, cwd=root,
                          capture_output=True, text=True, timeout=900)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"{what} exited {proc.returncode}:\n"
                             f"{proc.stderr[-4000:]}")
    return proc.stderr, secs


def _ex_evals(log):
    """The (step, metrics) of every eval an Estimator logged."""
    import ast
    import re

    return [(int(m[1]), ast.literal_eval(m[2])) for m in re.finditer(
        r"eval\[mnist-eval\] @ step (\d+): (\{.*\})", log)]


def _ex_recipe(dev, root, dp_ms):
    """`python -m tfde_tpu_torch.mnist_estimator` as a user runs it (one
    epoch); then its artifact served on the card against the restored
    model and against its own CPU serving, its accuracy against the
    final eval, and the export, bytes and times of an artifact."""
    import re

    from tfde_tpu_torch.checkpoint.manager import CheckpointManager
    from tfde_tpu_torch.data import datasets
    from tfde_tpu_torch.export import export_serving, load_serving
    from tfde_tpu_torch.models.cnn import BatchNormCNN
    from tfde_tpu_torch.training.optimizers import sgd
    from tfde_tpu_torch.training.step import init_state

    d = os.path.join(root, "estimator")
    argv = ["tfde_tpu_torch.mnist_estimator", "--working-dir", d,
            "--num-epochs", "1", "--no-tensorboard"]
    log, secs = _ex_child(argv, root, "mnist_estimator")
    evals = _ex_evals(log)
    rates = [float(x) for x in re.findall(r"step \d+: ([\d.]+) steps/sec",
                                          log)]
    steps = CheckpointManager(os.path.join(d, "checkpoints")).all_steps()
    export_dir = os.path.join(d, "export", "exporter")
    stamps = sorted(os.listdir(export_dir)) if os.path.isdir(export_dir) else []
    old = "not run in this call" if dp_ms is None else f"{dp_ms:.3f} ms"
    step_ms = [round(1e3 / r, 3) for r in rates]
    print(f"export recipe: python -m {' '.join(argv)} (BatchNormCNN at the "
          f"reference widths, batch 128, sgd(0.01), ParameterServerStrategy "
          f"at one process: bootstrap builds no group, so the update is "
          f"replicated) exit 0 in {secs:.1f} s; checkpoints {steps}, "
          f"artifacts {stamps}; evals {evals}; ms per step by 100-step window "
          f"(1 / the logged steps/sec) {step_ms}, the dp phase's old loop "
          f"{old}; on {_card()}")
    if not (steps and steps[-1] == 468 and len(stamps) == 1 and evals
            and evals[-1][0] == 468 and math.isfinite(evals[-1][1]["loss"])):
        raise AssertionError(f"mnist_estimator: checkpoints {steps}, "
                             f"artifacts {stamps}, evals {evals}")
    final = evals[-1][1]

    # the artifact against the model restored from the last checkpoint
    _, (ex, ey) = datasets.mnist(flatten=True)
    model = BatchNormCNN(device=dev, seed=1)
    state = init_state(model, sgd(model, 0.01))
    CheckpointManager(os.path.join(d, "checkpoints")).restore_latest(state)
    served = load_serving(export_dir)
    on_cpu = load_serving(export_dir, device="cpu")
    x_all = torch.as_tensor(ex, device=dev)
    worst = {}
    with torch.no_grad():
        for n in EX_BATCHES:
            x = x_all[:n]
            got = served.module(x)
            live = torch.softmax(model(x), dim=-1)
            cpu = torch.as_tensor(on_cpu.predict(ex[:n]))
            if got.shape != (n, 10):
                raise AssertionError(f"served {tuple(got.shape)} for {n}")
            worst[n] = (float((got - live).abs().max()),
                        float((got.cpu() - cpu).abs().max()))
    probs = served.predict(ex)
    acc = float((probs.argmax(-1) == ey.reshape(-1)).mean())
    print(f"export served: {export_dir}/{stamps[0]} on {served.device}: "
          f"max abs against the restored model's softmax on the card and "
          f"against the same artifact served on the CPU, by batch size "
          f"{worst} (tol {EX_TOL:g}, TF32 off); argmax accuracy over "
          f"{len(ex)} test images {acc:.4f} against the final eval's "
          f"{final['accuracy']:.4f} (tol {EX_ACC_TOL:g})")
    if not (all(a <= EX_TOL and c <= EX_TOL for a, c in worst.values())
            and abs(acc - final["accuracy"]) <= EX_ACC_TOL):
        raise AssertionError("the served artifact disagrees")

    # an export of the restored model: seconds, bytes; served and live ms
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = export_serving(model, (None, 784), os.path.join(root, "timing"))
    export_s = time.perf_counter() - t0
    size = sum(os.path.getsize(os.path.join(out, f)) for f in os.listdir(out))
    x = x_all[:128]
    with torch.no_grad():
        served_ms = _time_ms(lambda: served.module(x), dev)
        live_ms = _time_ms(lambda: torch.softmax(model(x), dim=-1), dev)
        walls = []
        for fn in (lambda: served.module(x),
                   lambda: torch.softmax(model(x), dim=-1)):
            for _ in range(5):
                fn()
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            for _ in range(50):
                fn()
            torch.cuda.synchronize(dev)
            walls.append((time.perf_counter() - t0) * 1e3 / 50)
    print(f"export timing: export_serving of BatchNormCNN {export_s:.2f} s "
          f"(a CPU copy traced by torch.export, written); artifact "
          f"{size} bytes ({', '.join(sorted(os.listdir(out)))}); a batch of "
          f"128: served {served_ms:.4f} ms, live {live_ms:.4f} ms device "
          f"time (CUDA events, L2 flushed); {walls[0]:.4f} and "
          f"{walls[1]:.4f} ms a call on the host clock over 50 calls; on "
          f"{_card()}")


def _ex_best(dev, root):
    """train_and_evaluate with a BestExporter over two throttled evals (a
    throttle of 0: one after each of 2 steps) and the final one: the
    newest artifact must be the one best_metric.json names."""
    from tfde_tpu_torch.data import Dataset, datasets
    from tfde_tpu_torch.export import BestExporter
    from tfde_tpu_torch.models.cnn import BatchNormCNN
    from tfde_tpu_torch.parallel.strategies import ParameterServerStrategy
    from tfde_tpu_torch.training import (
        Estimator, EvalSpec, RunConfig, TrainSpec, train_and_evaluate)
    from tfde_tpu_torch.training.optimizers import sgd

    (tx, ty), (ex, ey) = datasets.mnist(flatten=True)
    d = os.path.join(root, "best")
    model = BatchNormCNN(device=dev, seed=0)
    est = Estimator(model, sgd(model, 0.2, momentum=0.9),
                    ParameterServerStrategy(),
                    RunConfig(model_dir=d, save_checkpoints_steps=None))
    def eval_fn():
        return Dataset.from_tensor_slices((ex, ey)).batch(DP_EVAL_BATCH)

    _, final = train_and_evaluate(
        est, TrainSpec(lambda: Dataset.from_tensor_slices((tx, ty))
                       .shuffle(len(tx), seed=0).repeat()
                       .batch(DP_BATCH, drop_remainder=True), 2),
        EvalSpec(eval_fn, exporters=[BestExporter("best", (None, 784))],
                 start_delay_secs=0, throttle_secs=0))
    est.close()
    best = os.path.join(d, "export", "best")
    stamps = sorted((x for x in os.listdir(best) if x.isdigit()), key=int)
    with open(os.path.join(best, "best_metric.json")) as f:
        bar = json.load(f)
    print(f"export best: BestExporter over the evals after steps 1 and 2 and "
          f"the final one ({final}): artifacts {stamps}, best_metric.json "
          f"{bar}")
    if bar["artifact"] != os.path.join(best, stamps[-1]):
        raise AssertionError("the newest artifact is not the best one")


def _ex_tf2(root):
    """The second recipe: mnist_tf2's custom loop, then its Estimator."""
    import re

    log, secs = _ex_child(["tfde_tpu_torch.mnist_tf2", "--custom-loop",
                           "--max-steps", "100"], root, "mnist_tf2 custom")
    m = re.search(r"custom loop done: step=(\d+) loss=([\d.naif]+)", log)
    d2 = os.path.join(root, "tf2")
    log2, secs2 = _ex_child(["tfde_tpu_torch.mnist_tf2", "--model-dir", d2,
                             "--max-steps", "200"], root, "mnist_tf2")
    evals = _ex_evals(log2)
    stamps = os.listdir(os.path.join(d2, "export", "exporter"))
    print(f"export tf2: --custom-loop --max-steps 100: {m and m.group(0)} "
          f"({secs:.1f} s); --model-dir --max-steps 200: final eval "
          f"{evals[-1] if evals else None}, artifacts {stamps} "
          f"({secs2:.1f} s)")
    if not (m and int(m[1]) == 100 and math.isfinite(float(m[2])) and evals
            and evals[-1][0] == 200 and math.isfinite(evals[-1][1]["loss"])
            and len(stamps) == 1):
        raise AssertionError("mnist_tf2 did not end as it should")


def _ex_flash_refused(dev, root):
    """A GPT whose forward launches the flash kernels on the card must not
    export: NotImplementedError, after one probe launch."""
    from tfde_tpu_torch.export import export_serving
    from tfde_tpu_torch.models.gpt import GPT
    from tfde_tpu_torch.ops import flash_attention as fa

    model = GPT(vocab_size=97, hidden_size=128, depth=1, num_heads=2,
                mlp_dim=256, max_position=64, dtype=torch.bfloat16,
                device=dev)
    before = fa.flash_forward.launches
    try:
        export_serving(model, (None, 16), os.path.join(root, "gpt"),
                       input_dtype=torch.int64)
    except NotImplementedError as e:
        print(f"export gpt: a GPT (head dim 64) on the card refused after "
              f"{fa.flash_forward.launches - before} probe launch: {e}")
    else:
        raise AssertionError("a flash GPT exported from the card")
    if fa.flash_forward.launches - before != 1:
        raise AssertionError("the probe did not launch the flash kernel")


def _ex_cards():
    """On a machine with two cards or more: ParameterServerStrategy, one
    process a card on NCCL (`testing.ps_ranks_worker`), against the
    mirrored run of the same steps; the same bits on every rank, and each
    rank's optimizer-state bytes."""
    from tfde_tpu_torch.data import datasets
    from tfde_tpu_torch.models.cnn import BatchNormCNN
    from tfde_tpu_torch.testing import ps_ranks_worker, run_ranks

    n = torch.cuda.device_count()
    if n < 2:
        print(f"export cards: {n} card on this machine; the run across cards "
              f"needs two or more (not run)")
        return
    (tx, ty), _ = datasets.mnist(flatten=True, n_train=320, n_test=8)
    batches = [(tx[i * 64:(i + 1) * 64], ty[i * 64:(i + 1) * 64])
               for i in range(5)]
    initial = {k: v.numpy() for k, v in BatchNormCNN(
        dropout_rate=0.0, device="cpu", seed=0).state_dict().items()}
    store = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "build", f"ps_store_{os.getpid()}")
    os.makedirs(os.path.dirname(store), exist_ok=True)
    try:
        out = run_ranks(ps_ranks_worker, [
            (n, store, ("BatchNormCNN", initial, batches, 0.05, 0.9))] * n,
            timeout=600)
    finally:
        if os.path.exists(store):
            os.remove(store)
    ps = [o["ParameterServerStrategy"] for o in out]
    mirrored = out[0]["MultiWorkerMirroredStrategy"]
    same = all(np.array_equal(v, o["state_dict"][k]) for o in ps[1:]
               for k, v in ps[0]["state_dict"].items())
    err = max(float(np.abs(v - mirrored["state_dict"][k]).max())
              for k, v in ps[0]["state_dict"].items())
    bits = err == 0.0
    opt_bytes = [o["opt_state_bytes"] for o in ps]
    print(f"export cards: ParameterServerStrategy over {n} cards on NCCL "
          f"(BatchNormCNN, 5 sgd(0.05, momentum 0.9) steps of 64, "
          f"cudnn.deterministic): the same bits on every rank: {same}; "
          f"against the mirrored run max abs {err:.3e} (bits equal: {bits}); "
          f"optimizer-state bytes a rank {opt_bytes} (mirrored "
          f"{mirrored['opt_state_bytes']}), on {n} x {_card()}")
    if not same or err > 1e-7:
        raise AssertionError("the PS run across cards disagrees")
    if n in EX_PS_BYTES and set(opt_bytes) != {EX_PS_BYTES[n]}:
        raise AssertionError(f"optimizer-state bytes {opt_bytes}, not "
                             f"{EX_PS_BYTES[n]}")


def phase_export(dev, dp_ms=None):
    """The reference's two Estimator recipes and the serving export on the
    card (docstring, phase 10). Every directory lies under build/ and is
    removed at the end."""
    import shutil

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        f"export_{os.getpid()}")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    try:
        _ex_recipe(dev, root, dp_ms)
        _ex_best(dev, root)
        _ex_tf2(root)
        _ex_flash_refused(dev, root)
        _ex_cards()
    finally:
        shutil.rmtree(root, ignore_errors=True)


PHASES = ("kernels", "parity", "train_parity", "serve", "train", "dp",
          "lifecycle", "export")


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
    dp_ms = phase_dp(dev) if "dp" in phases else None
    if "lifecycle" in phases:
        phase_lifecycle(fa, dev, dp_ms)
    if "export" in phases:
        phase_export(dev, dp_ms)
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
