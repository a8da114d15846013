"""GPT causal-LM pretraining on one GPU — counterpart of the single-device
path of `examples/gpt_lm.py`.

Trains GPT-2 small (or the tiny CI config) from random weights made from
`--seed`, with fp32 master weights and bf16 compute, masked AdamW (weight
decay 0.1) under a linear-warmup cosine schedule, and the next-token
loss, on the synthetic Markov corpus (`data.datasets.synthetic_tokens`).
Every attention call runs the CUDA flash forward and its gradient the
CUDA backward pair. Runs on CUDA by default:

    python -m tfde_tpu_torch.gpt_lm --seq-len 1024 --batch-size 8 --max-steps 20
    python -m tfde_tpu_torch.gpt_lm --tiny --device cpu --max-steps 3 \\
        --batch-size 4 --seq-len 16 --train-examples 64

The JAX example's strategies and model options (--seq-parallel,
--pipeline, --moe, --packed, --kv-heads, --rope, --sliding-window,
--remat, --generate, ...) are not ported yet; an unknown flag is an
error.
"""

from __future__ import annotations

import argparse
import logging
import time

import numpy as np
import torch

from tfde_tpu_torch.data import datasets
from tfde_tpu_torch.models.gpt import GPT2Small, gpt_tiny_test, next_token_loss
from tfde_tpu_torch.training.optimizers import (
    adamw, warmup_cosine_decay_schedule)
from tfde_tpu_torch.training.step import init_state, make_custom_train_step
from tfde_tpu_torch.utils.devices import resolve_device

log = logging.getLogger("gpt_lm")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--seq-len", type=int, default=256)
    parser.add_argument("--max-steps", type=int, default=1000)
    parser.add_argument("--learning-rate", type=float, default=3e-4)
    parser.add_argument("--warmup-steps", type=int, default=100)
    parser.add_argument("--train-examples", type=int, default=8192)
    parser.add_argument("--grad-accum", type=int, default=1,
                        help="sequential microbatches per optimizer update")
    parser.add_argument("--tiny", action="store_true",
                        help="the tiny CI config instead of GPT-2 small; its "
                             "head dim 8 runs with --device cpu only (the "
                             "CUDA flash kernels take head dims 64 and 128)")
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--seed", type=int, default=0,
                        help="seeds the random weights")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    model = (gpt_tiny_test if args.tiny else GPT2Small)(device=device,
                                                        seed=args.seed)
    if args.seq_len > model.max_position:
        raise ValueError(f"--seq-len {args.seq_len} exceeds the model's "
                         f"{model.max_position} positions")
    tokens = datasets.synthetic_tokens(args.train_examples, args.seq_len,
                                       vocab=model.vocab_size)
    schedule = warmup_cosine_decay_schedule(
        0.0, args.learning_rate,
        warmup_steps=min(args.warmup_steps, max(args.max_steps - 1, 1)),
        decay_steps=args.max_steps)
    state = init_state(model, adamw(model, schedule, weight_decay=0.1))
    step_fn = make_custom_train_step(next_token_loss,
                                     grad_accum=args.grad_accum)
    generator = torch.Generator(device=device).manual_seed(1)
    nrng = np.random.default_rng(0)
    t0, since = time.perf_counter(), 0
    metrics = {}
    for step in range(args.max_steps):
        idx = nrng.integers(0, len(tokens), args.batch_size)
        batch = (torch.as_tensor(tokens[idx], device=device),)
        state, metrics = step_fn(state, batch, generator)
        if (step + 1) % 100 == 0 or step + 1 == args.max_steps:
            vals = {k: float(v) for k, v in metrics.items()}  # syncs
            sps = (step + 1 - since) / (time.perf_counter() - t0)
            t0, since = time.perf_counter(), step + 1
            log.info("step %d: %s (%.2f steps/s)", step + 1, vals, sps)
    return state, metrics


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, force=True)
    main()
