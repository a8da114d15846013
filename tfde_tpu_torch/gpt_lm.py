"""GPT causal-LM pretraining on one GPU — counterpart of the single-device
path of `examples/gpt_lm.py`.

Trains GPT-2 small (or the tiny CI config) from random weights made from
`--seed`, with fp32 master weights and bf16 compute, masked AdamW (weight
decay 0.1) under a linear-warmup cosine schedule, and the next-token
loss, on the synthetic Markov corpus (`data.datasets.synthetic_tokens`).
Every unmasked attention call runs the CUDA flash forward and its
gradient the CUDA backward pair. Model options: `--rope` (rotary
positions, no wpe table), `--kv-heads N` (grouped-query attention),
`--sliding-window N`, `--remat [full|dots]` (each block checkpointed:
the flash forward runs again in the backward). `--packed` trims the
corpus's rows to document lengths drawn by `default_rng(7)` and packs
them (`data.packing`): the segment mask sends attention to the reference
einsum, and the loss is `packed_next_token_loss`; it does not compose
with `--sliding-window`. `--moe E` makes every second block's MLP an
E-expert routed MoE (`models/moe.py`: top-2, capacity factor 1.25, gelu
+ bias experts) whose load-balance loss joins the objective and the
logged metrics (``moe_aux``), under `ExpertParallelStrategy` at an expert
axis of 1, as the JAX example picks it on one device.

After training, `--generate N` samples N tokens after a 16-token prompt
from the first two training rows (`inference.decode.generate`, the JAX
example's sampling: temperature 0.8, top-k 40, seed 2; `--temperature 0`
decodes greedily), and `--export-generate DIR` also writes the whole
decode loop as a generative artifact with the same sampling under DIR
(`export.generative.export_generate`; `load_generate(DIR)` serves it, and
its tokens for seed 2 are the ones logged). `--beams K` decodes by beam
search instead (`inference.beam.beam_search`, K beams, length penalty
0.6) and logs each prompt's best beam and its score; it does not export.
Runs on CUDA by default:

    python -m tfde_tpu_torch.gpt_lm --seq-len 1024 --batch-size 8 --max-steps 20
    python -m tfde_tpu_torch.gpt_lm --rope --kv-heads 4 --sliding-window 256 \\
        --remat --seq-len 1024 --batch-size 8 --max-steps 20
    python -m tfde_tpu_torch.gpt_lm --seq-len 1024 --batch-size 8 \\
        --max-steps 20 --generate 32 --export-generate /tmp/gen
    python -m tfde_tpu_torch.gpt_lm --tiny --device cpu --max-steps 3 \\
        --batch-size 4 --seq-len 16 --train-examples 64 --packed --rope
    python -m tfde_tpu_torch.gpt_lm --tiny --device cpu --max-steps 3 \\
        --batch-size 4 --seq-len 16 --train-examples 64 --generate 4 --beams 2
    python -m tfde_tpu_torch.gpt_lm --moe 8 --seq-len 1024 --batch-size 8 \\
        --max-steps 10

The JAX example's other strategies and options (--seq-parallel,
--pipeline, --tensor, --fake-devices, ...) are not ported yet; an unknown
flag is an error (so `--moe` never meets `--pipeline` or
`--seq-parallel`, which the JAX example refuses beside it).
"""

from __future__ import annotations

import argparse
import logging
import time

import numpy as np
import torch

from tfde_tpu_torch.data import datasets
from tfde_tpu_torch.data.packing import pack_documents, packed_next_token_loss
from tfde_tpu_torch.export.generative import export_generate
from tfde_tpu_torch.inference.beam import beam_search
from tfde_tpu_torch.inference.decode import generate
from tfde_tpu_torch.models.gpt import GPT2Small, gpt_tiny_test, next_token_loss
from tfde_tpu_torch.parallel.strategies import ExpertParallelStrategy
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
                        help="the tiny CI config instead of GPT-2 small; on "
                             "CUDA the flash kernels run its head dim 8 "
                             "zero-padded to 64")
    parser.add_argument("--packed", action="store_true",
                        help="pack variable-length synthetic documents into "
                             "fixed rows with block-diagonal attention and "
                             "a boundary-masked loss")
    parser.add_argument("--kv-heads", type=int, default=0,
                        help="grouped-query attention: KV heads per layer "
                             "(0 = classic MHA)")
    parser.add_argument("--rope", action="store_true",
                        help="rotary position embeddings instead of the "
                             "learned GPT-2 table")
    parser.add_argument("--sliding-window", type=int, default=0,
                        help="each position attends the last N only")
    parser.add_argument("--remat", nargs="?", const="full", default=False,
                        choices=["full", "dots"])
    parser.add_argument("--moe", type=int, default=0, metavar="E",
                        help="experts per MoE block (every second block); "
                             "ExpertParallelStrategy at an expert axis of "
                             "1 (experts replicated)")
    parser.add_argument("--generate", type=int, default=0, metavar="N",
                        help="after training, sample N continuation tokens "
                             "from a training prompt (inference/decode.py)")
    parser.add_argument("--beams", type=int, default=0, metavar="K",
                        help="with --generate: beam-search decode with K "
                             "beams (inference/beam.py) instead of sampling")
    parser.add_argument("--export-generate", type=str, default=None,
                        metavar="DIR",
                        help="with --generate: also export the whole decode "
                             "loop as a torch.export serving artifact "
                             "(export/generative.py) under DIR")
    parser.add_argument("--temperature", type=float, default=0.8,
                        help="with --generate: the sampling temperature "
                             "(0: greedy); top-k 40 either way")
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--seed", type=int, default=0,
                        help="seeds the random weights")
    args = parser.parse_args(argv)

    if args.packed and args.sliding_window > 0:
        raise ValueError("--packed doesn't compose with --sliding-window")
    if args.beams > 0 and args.generate <= 0:
        raise ValueError("--beams selects the decode mode for --generate; "
                         "pass --generate N to produce output")
    if args.export_generate and args.generate <= 0:
        raise ValueError("--export-generate sizes the artifact from "
                         "--generate; pass --generate N to export")
    if args.export_generate and args.beams > 0:
        raise ValueError("--export-generate exports the sampling decode "
                         "loop; exporting beam search is not supported yet "
                         "— drop --beams to export, or drop "
                         "--export-generate to beam-decode in process")
    device = resolve_device(args.device)
    model_kw = {"remat": args.remat}
    if args.rope:
        model_kw["position"] = "rope"
    if args.kv_heads > 0:
        model_kw["num_kv_heads"] = args.kv_heads
    if args.sliding_window > 0:
        model_kw["sliding_window"] = args.sliding_window
    if args.moe > 1:
        model_kw["num_experts"] = args.moe
    model = (gpt_tiny_test if args.tiny else GPT2Small)(
        device=device, seed=args.seed, **model_kw)
    if not args.rope and args.seq_len > model.max_position:
        raise ValueError(f"--seq-len {args.seq_len} exceeds the model's "
                         f"{model.max_position} positions")
    tokens = datasets.synthetic_tokens(args.train_examples, args.seq_len,
                                       vocab=model.vocab_size)
    seg = None
    if args.packed:
        # each row an independent Markov sequence trimmed to a document
        # length, as the JAX example draws them
        lengths = np.random.default_rng(7).integers(
            args.seq_len // 4, args.seq_len, args.train_examples)
        docs = [tokens[i, :int(n)] for i, n in enumerate(lengths)]
        tokens, seg = pack_documents(docs, args.seq_len)
        log.info("packed %d docs into %d rows (fill %.0f%%)", len(docs),
                 len(tokens), 100 * (seg > 0).mean())
    schedule = warmup_cosine_decay_schedule(
        0.0, args.learning_rate,
        warmup_steps=min(args.warmup_steps, max(args.max_steps - 1, 1)),
        decay_steps=args.max_steps)
    state = init_state(model, adamw(model, schedule, weight_decay=0.1))
    # the JAX example's ExpertParallelStrategy over every device: one
    # device here, an expert axis of 1 (more ranks raise, not ported)
    strategy = ExpertParallelStrategy() if args.moe > 1 else None
    step_fn = make_custom_train_step(
        packed_next_token_loss if args.packed else next_token_loss,
        grad_accum=args.grad_accum, strategy=strategy,
        state=None if strategy is None else state)
    generator = torch.Generator(device=device).manual_seed(1)
    arrays = (tokens,) if seg is None else (tokens, seg)
    nrng = np.random.default_rng(0)
    t0, since = time.perf_counter(), 0
    metrics = {}
    for step in range(args.max_steps):
        idx = nrng.integers(0, len(tokens), args.batch_size)
        batch = tuple(torch.as_tensor(a[idx], device=device) for a in arrays)
        state, metrics = step_fn(state, batch, generator)
        if (step + 1) % 100 == 0 or step + 1 == args.max_steps:
            vals = {k: float(v) for k, v in metrics.items()}  # syncs
            sps = (step + 1 - since) / (time.perf_counter() - t0)
            t0, since = time.perf_counter(), step + 1
            log.info("step %d: %s (%.2f steps/s)", step + 1, vals, sps)

    if args.generate > 0:
        if seg is not None:
            # packed rows hold several documents: prompt from each row's
            # FIRST document only, at a common length
            keep = min(int((seg[0] == 1).sum()), int((seg[1] == 1).sum()),
                       16, args.seq_len)
        else:
            keep = min(16, args.seq_len)
        prompt = tokens[:2, :keep]
        # one sampling config for the in-process decode AND the export, so
        # the artifact reproduces exactly what was just logged
        sampling = dict(temperature=args.temperature, top_k=40)
        if args.beams > 0:
            out, scores, lengths = beam_search(
                model, prompt, args.generate, num_beams=args.beams,
                device=device)
            for row, score, n in zip(out[:, 0].cpu().numpy(),
                                     scores[:, 0].cpu().numpy(),
                                     lengths[:, 0].cpu().numpy()):
                log.info("beam best (%.3f): %s", score, row[:int(n)].tolist())
        else:
            out, lengths = generate(model, prompt, args.generate,
                                    device=device, seed=2, **sampling)
            for row, n in zip(out.cpu().numpy(), lengths.cpu().numpy()):
                log.info("generated: %s", row[:int(n)].tolist())
        if args.export_generate:
            d = export_generate(model, args.export_generate,
                                prompt_len=prompt.shape[1],
                                max_new_tokens=args.generate,
                                batch_size=prompt.shape[0], **sampling)
            log.info("generative serving artifact: %s", d)
    return state, metrics


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, force=True)
    main()
