"""Continuous-batching GPT serving demo on the port — counterpart of
`examples/serve_gpt.py`.

Serves synthetic random-token requests through
`inference.server.ContinuousBatcher` over GPT-2 small (or the tiny CI
config) with random weights made from `--seed`. Runs on CUDA by default:

    python -m tfde_tpu_torch.serve_gpt --requests 16
    python -m tfde_tpu_torch.serve_gpt --tiny --device cpu --requests 6
"""

from __future__ import annotations

import argparse
import logging
import time

import numpy as np
import torch

from tfde_tpu_torch.inference.server import ContinuousBatcher
from tfde_tpu_torch.models.gpt import GPT2Small, gpt_tiny_test
from tfde_tpu_torch.utils.devices import resolve_device

log = logging.getLogger("serve_gpt")


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--batch-size", type=int, default=4,
                        help="resident decode rows")
    parser.add_argument("--max-len", type=int, default=128,
                        help="per-row cache budget (prompt + generated)")
    parser.add_argument("--max-new-tokens", type=int, default=24)
    parser.add_argument("--requests", type=int, default=12,
                        help="synthetic requests to serve")
    parser.add_argument("--temperature", type=float, default=0.0)
    parser.add_argument("--top-k", type=int, default=None)
    parser.add_argument("--top-p", type=float, default=None)
    parser.add_argument("--min-p", type=float, default=None)
    parser.add_argument("--repetition-penalty", type=float, default=1.0,
                        help="CTRL rule over each row's prompt+output "
                             "(1.0 = off); acts under greedy decoding too")
    parser.add_argument("--eos-id", type=int, default=None)
    parser.add_argument("--scan-depth", type=int, default=4, metavar="K",
                        help="decode ticks per host round-trip (adapts "
                             "down near row completions; 1 = a host sync "
                             "every token)")
    parser.add_argument("--tiny", action="store_true",
                        help="the tiny CI config instead of GPT-2 small; its "
                             "head dim 8 runs with --device cpu only (the "
                             "CUDA flash kernel takes head dims 64 and 128)")
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--seed", type=int, default=0,
                        help="seeds the random weights, prompts and draws")
    args = parser.parse_args(argv)

    if args.temperature == 0.0 and (args.top_k is not None
                                    or args.top_p is not None
                                    or args.min_p is not None):
        raise SystemExit(
            "--top-k/--top-p/--min-p only act when sampling — set "
            "--temperature > 0")
    device = resolve_device(args.device)
    build = gpt_tiny_test if args.tiny else GPT2Small
    model = build(device=device, seed=args.seed).cast_compute_weights_()
    log.warning("serving RANDOM weights (seed %d)", args.seed)
    srv = ContinuousBatcher(
        model, batch_size=args.batch_size, max_len=args.max_len,
        temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
        min_p=args.min_p, repetition_penalty=args.repetition_penalty,
        eos_id=args.eos_id, scan_depth=args.scan_depth,
        generator=torch.Generator(device=device).manual_seed(args.seed),
        device=device)
    rng = np.random.default_rng(args.seed)
    lengths = {}
    for _ in range(args.requests):
        plen = int(rng.integers(2, 9))
        rid = srv.submit(rng.integers(0, model.vocab_size, plen),
                         args.max_new_tokens)
        lengths[rid] = plen
    t0 = time.perf_counter()
    done = srv.run()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    total = sum(len(toks) for _, toks in done)
    for rid, toks in done:
        log.info("req %d: prompt %d -> %d tokens", rid, lengths[rid],
                 len(toks))
    log.info("served %d requests / %d tokens in %.2fs (%.1f tok/s, batch "
             "%d, %s)", len(done), total, dt, total / max(dt, 1e-9),
             args.batch_size, device)
    log.info("serving stats: %s", srv.stats())
    return done


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
