"""Continuous-batching GPT serving demo on the port — counterpart of
`examples/serve_gpt.py`.

Serves synthetic random-token requests through
`inference.server.ContinuousBatcher` (or, with `--num-draft K`,
`SpeculativeContinuousBatcher`) over a converted checkpoint
(`--hf-dir`: an artifact of `python -m tfde_tpu_torch.models.convert`, or
of the JAX package's converter), or over GPT-2 small (or the tiny CI
config) with random weights made from `--seed`. Runs on CUDA by default:

    python -m tfde_tpu_torch.serve_gpt --hf-dir DIR --requests 16
    python -m tfde_tpu_torch.serve_gpt --requests 16
    python -m tfde_tpu_torch.serve_gpt --tiny --device cpu --requests 6
    python -m tfde_tpu_torch.serve_gpt --prefix-cache on --shared-prefix 512
    TFDE_PAGED_KV=1 python -m tfde_tpu_torch.serve_gpt --prefix-cache on
    python -m tfde_tpu_torch.serve_gpt --serve 8100

Request i's prompt is `rng.integers(0, vocab, rng.integers(2, 9))` from
`np.random.default_rng(--seed)`, drawn in order, after a system prompt of
`--shared-prefix` tokens drawn first (default none). `--prefix-cache`
(on, off or a byte budget; default the ``TFDE_PREFIX_CACHE`` knob) lets
requests that share a cached prompt prefix prefill only the rest;
``TFDE_PAGED_KV=1`` serves from the paged block pool (inference/paged.py);
``TFDE_KV_QUANT=int8`` stores every cache in int8 with fp32 scale planes.
`--num-draft K` serves greedily through the speculative batcher, K draft
proposals a round, with the JAX example's draft: a GPT of the target's
vocabulary and positions at a quarter of its width and depth (hidden
max(h // 4, 8), depth max(d // 4, 1), heads max(n // 4, 1), MLP
max(m // 4, 16)), random weights from seed 7; it refuses `--prefix-cache`,
the sampling flags and `--repetition-penalty`, as JAX's does. The log
ends with the KV ledger (`kv_stats()`: allocated and used bytes,
waste, headroom rows) beside the trie's and the pool's stats.

`--serve PORT` serves no synthetic batch: the batcher (plain or
speculative) goes behind an HTTP/SSE `inference.router.ReplicaServer` on
127.0.0.1:PORT (0: an ephemeral port; the URL is logged) until Ctrl-C;
`inference.router.Router` fronts several such replicas with the
/v1/generate door.
"""

from __future__ import annotations

import argparse
import logging
import time

import numpy as np
import torch

from tfde_tpu_torch.inference.server import (
    ContinuousBatcher, SpeculativeContinuousBatcher)
from tfde_tpu_torch.models.convert import load_converted
from tfde_tpu_torch.models.gpt import GPT, GPT2Small, gpt_tiny_test
from tfde_tpu_torch.utils.devices import resolve_device

log = logging.getLogger("serve_gpt")


def _prefix_spec(text: str):
    """--prefix-cache: 'on', 'off' or an integer byte budget."""
    v = text.strip().lower()
    if v in ("on", "off"):
        return v
    try:
        return int(v)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"{text!r} is not on, off or a byte budget") from None


def quarter_draft(model, device, seed: int = 7) -> GPT:
    """The JAX example's draft for `--num-draft`: a GPT of `model`'s
    vocabulary, positions and dtype at a quarter of its width and depth
    (hidden max(h // 4, 8), depth max(d // 4, 1), heads max(n // 4, 1),
    MLP max(m // 4, 16)), random weights from `seed`, its matmul weights
    cast to the compute dtype."""
    return GPT(vocab_size=model.vocab_size,
               hidden_size=max(model.hidden_size // 4, 8),
               depth=max(model.depth // 4, 1),
               num_heads=max(model.num_heads // 4, 1),
               mlp_dim=max(model.mlp_dim // 4, 16),
               max_position=model.max_position, dtype=model.dtype,
               device=device, seed=seed).cast_compute_weights_()


def _serve(srv, port: int) -> list:
    """`srv` behind a ReplicaServer on 127.0.0.1:`port` until Ctrl-C."""
    from tfde_tpu_torch.inference.router import ReplicaServer

    rs = ReplicaServer(srv, port=port).start()
    log.info("replica serving on %s (POST /generate, GET /healthz); "
             "Ctrl-C to stop", rs.url)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        rs.close()
    return []


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
    parser.add_argument("--num-draft", type=int, default=0, metavar="K",
                        help="serve through SpeculativeContinuousBatcher "
                             "with K draft proposals a round (greedy only; "
                             "the draft is a random quarter-size GPT)")
    parser.add_argument("--prefix-cache", type=_prefix_spec, default=None,
                        metavar="SPEC",
                        help="prefix-KV cache: 'on', 'off', or a byte "
                             "budget (default: the TFDE_PREFIX_CACHE knob); "
                             "requests sharing a cached prompt prefix "
                             "prefill only the uncached suffix")
    parser.add_argument("--shared-prefix", type=int, default=0, metavar="N",
                        help="start every synthetic prompt with the same "
                             "N-token system prompt (what the prefix cache "
                             "reuses)")
    parser.add_argument("--serve", type=int, default=None, metavar="PORT",
                        help="instead of the synthetic one-shot batch: "
                             "expose this batcher as an HTTP/SSE replica "
                             "on 127.0.0.1:PORT (POST /generate, GET "
                             "/healthz; 0 picks a free port) until "
                             "interrupted; front several with "
                             "inference.router.Router")
    parser.add_argument("--hf-dir", type=str, default=None,
                        help="serve a conversion artifact (params.npz + "
                             "model_config.json from `python -m "
                             "tfde_tpu_torch.models.convert`) instead of "
                             "random weights; on CUDA its head dim must "
                             "be at most 128")
    parser.add_argument("--tiny", action="store_true",
                        help="the tiny CI config instead of GPT-2 small; on "
                             "CUDA the flash kernels run its head dim 8 "
                             "zero-padded to 64")
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--seed", type=int, default=0,
                        help="seeds the random weights, prompts and draws")
    args = parser.parse_args(argv)

    sampling_flags = (args.temperature != 0.0 or args.top_k is not None
                      or args.top_p is not None or args.min_p is not None)
    if args.temperature == 0.0 and (args.top_k is not None
                                    or args.top_p is not None
                                    or args.min_p is not None):
        raise SystemExit(
            "--top-k/--top-p/--min-p only act when sampling — set "
            "--temperature > 0")
    if args.num_draft > 0:
        if args.prefix_cache is not None:
            raise SystemExit(
                "--prefix-cache serves the plain batcher; the speculative "
                "batcher recomputes draft K/V per round and does not take "
                "a prefix cache")
        if sampling_flags or args.repetition_penalty != 1.0:
            raise ValueError(
                "--num-draft serves the plain greedy verifier; drop "
                "--temperature/--top-k/--top-p/--min-p/--repetition-penalty "
                "(speculative SAMPLING lives in generate_speculative, not "
                "the batcher's entry point)")
    device = resolve_device(args.device)
    if args.hf_dir:
        model = load_converted(args.hf_dir, device=device)
    else:
        build = gpt_tiny_test if args.tiny else GPT2Small
        model = build(device=device, seed=args.seed)
        log.warning("serving RANDOM weights (seed %d); pass --hf-dir for a "
                    "real model", args.seed)
    model.cast_compute_weights_()
    if args.num_draft > 0:
        srv = SpeculativeContinuousBatcher(
            model, quarter_draft(model, device),
            batch_size=args.batch_size, max_len=args.max_len,
            num_draft=args.num_draft, eos_id=args.eos_id, device=device)
    else:
        srv = ContinuousBatcher(
            model, batch_size=args.batch_size, max_len=args.max_len,
            temperature=args.temperature, top_k=args.top_k,
            top_p=args.top_p, min_p=args.min_p,
            repetition_penalty=args.repetition_penalty,
            eos_id=args.eos_id, scan_depth=args.scan_depth,
            generator=torch.Generator(device=device).manual_seed(args.seed),
            prefix_cache=args.prefix_cache, device=device)
    if args.serve is not None:
        return _serve(srv, args.serve)
    rng = np.random.default_rng(args.seed)
    system = rng.integers(0, model.vocab_size, args.shared_prefix)
    lengths = {}
    for _ in range(args.requests):
        plen = int(rng.integers(2, 9))
        prompt = np.concatenate(
            [system, rng.integers(0, model.vocab_size, plen)])
        rid = srv.submit(prompt, args.max_new_tokens)
        lengths[rid] = prompt.size
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
    kv = srv.kv_stats()
    log.info("KV ledger (%s): allocated %d bytes, used %d bytes, waste "
             "%.3f, headroom %d rows / %d tokens", kv["kv_dtype"],
             kv["allocated_bytes"], kv["used_bytes"], kv["waste_frac"],
             kv["headroom_rows"], kv["headroom_tokens"])
    if getattr(srv, "prefix_cache", None) is not None:
        log.info("prefix cache: %s", srv.prefix_cache.stats())
    if getattr(srv, "block_pool", None) is not None:
        log.info("paged KV pool: %s, defrag passes %d",
                 srv.block_pool.stats(), srv.defrag_passes)
    return done


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
