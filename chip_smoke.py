#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`tfde_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero
without printing a result:

1. device — the card's name and power limit from nvidia-smi;
2. build  — compile every kernel of the serving path from
   tfde_tpu_torch/csrc with nvcc (sm_90a);
3. kernels — each kernel against its plain PyTorch version on the card,
   over the serving shape and the option matrix, then its time beside the
   plain version's, the library call's (SDPA, timing only) and the bound;
4. parity — a small fp32 GPT with head_dim 64: logits of the CUDA model
   (flash prefill) against the same weights on the CPU (plain attention),
   and the CUDA batcher's greedy tokens against CPU `generate`;
5. serve  — GPT-2 small at full width (768 x 12 layers, 12 heads, MLP
   3072, vocab 50257, 1024 positions, bf16, random weights from seed 0)
   behind a ContinuousBatcher (batch 8, max_len 1024, scan depth 4,
   greedy) answering 16 requests of 16-960 prompt tokens x 32 new tokens;
   the launch counters are zeroed just before and read just after, and
   the flash kernel must have run 12 times per prefill wave; then one
   wave's first-token logits with attn_impl flash vs reference.

The last two lines are the kernels JSON line and
{"ok": true, "device": {...}}. The script imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

#: H100 SXM data-sheet peaks (dense)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
#: tolerances of a kernel against its plain version: out relative
#: Frobenius, lse max abs. bf16: the output's rounding to bf16; fp32: the
#: same sums in another order.
TOL = {torch.bfloat16: (1e-2, 1e-3), torch.float32: (1e-5, 1e-5)}


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _time_ms(fn, dev, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of `fn` over `iters` launches, each after a write
    of 256 MB that evicts the 50 MB L2, timed with CUDA events."""
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=dev)
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(iters):
        flush.zero_()
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


def _bound(b, s, h, kv, d, dtype, causal, window):
    """(least ms the H100 needs, 'bytes' | 'operations'): q/k/v read once,
    out/lse written once, over HBM bandwidth; 4*D FLOP per visible pair
    (QK^T and PV) over the peak of the input type."""
    item = torch.tensor([], dtype=dtype).element_size()
    nbytes = (2 * b * s * h * d + 2 * b * s * kv * d) * item + b * h * s * 4
    flops = 4 * d * _visible_pairs(s, causal, window) * b * h
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
    lib = fa.build(force=True)
    print(f"build: flash_fwd.cu -> {os.path.relpath(lib.path)} in "
          f"{lib.seconds:.2f} s")
    for line in lib.log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")


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
]


def phase_kernels(fa, dev):
    import torch.nn.functional as F

    gen = torch.Generator(device=dev).manual_seed(1)
    result = {}
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
        if name == "slice":
            result["max_abs_err"] = max_abs
            result["ms"] = _time_ms(
                lambda: fa.flash_forward(q, k, v, causal), dev)
            result["plain_ms"] = _time_ms(
                lambda: fa.flash_forward_reference(q, k, v, causal), dev,
                iters=5)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            result["library_ms"] = _time_ms(
                lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                       is_causal=True), dev)
            result["bound_ms"], result["bound_by"] = _bound(
                b, s, h, kv, d, dtype, causal, window)
            print(f"kernel flash_fwd slice timing: kernel_ms "
                  f"{result['ms']:.4f}, plain_ms {result['plain_ms']:.4f}, "
                  f"library_ms (SDPA) {result['library_ms']:.4f}, bound_ms "
                  f"{result['bound_ms']:.4f} ({result['bound_by']})")
    return result


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


def main() -> int:
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
    timing = phase_kernels(fa, dev)
    phase_parity(dev)
    launches = phase_serve(fa, dev)
    kernel = {
        "name": "flash_fwd",
        "route": "cuda",
        "source": "tfde_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "tfde_tpu/ops/flash_attention.py:188",
        "launches": launches,
        "max_abs_err": timing["max_abs_err"],
        "ms": timing["ms"],
        "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"],
        "library_ms": timing["library_ms"],
    }
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
