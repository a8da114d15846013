"""BERT-base masked-LM pretraining, sequence-batch data parallelism —
counterpart of `examples/bert_mlm.py` (BASELINE.json configs[4]).

The custom-training-loop recipe: the loss is the example's own
(`mlm_loss_fn`: the masked-LM CE over the target positions, the target
count as ``grad_weight``), and `make_custom_train_step` under
`MultiWorkerMirroredStrategy` (DDP over the ranks `bootstrap()` joins)
does the differentiation, the global normalisation and the update:

- `BertBase` (post-LN, 12 x 768, 12 heads, MLP 3072, vocab 30522, bf16
  compute over fp32 master weights, dropout 0.1) or `bert_tiny_test`
  with ``--tiny``, random weights from ``--seed``; every attention call
  runs the CUDA flash kernels (non-causal, unmasked);
- masked AdamW (weight decay 0.01) under a linear warmup and a cosine
  decay over ``--max-steps``;
- data: `datasets.synthetic_tokens` over vocab - 1 (the last id is
  [MASK]), masked on the host by `data.mlm.mask_tokens` (80/10/10), one
  global batch a step (`batch_stream`), each rank keeping its rows;
- ``--model-dir``: resume from its newest checkpoint, a checkpoint every
  500 steps and at the end, scalar summaries every 100 steps (rank 0).

    python -m tfde_tpu_torch.bert_mlm --max-steps 100               # one GPU
    python -m tfde_tpu_torch.bert_mlm --tiny --device cpu --seq-len 32 \\
        --max-steps 2 --batch-size 16
    TFDE_NUM_PROCESSES=2 TFDE_PROCESS_ID=<r> TFDE_COORDINATOR=host0:2222 \\
        python -m tfde_tpu_torch.bert_mlm                           # each host

``--remat [full|dots]`` checkpoints each encoder block (the flash forward
runs again in the backward). The JAX example's ``--fake-devices`` is not
ported; an unknown flag is an error.
"""

from __future__ import annotations

import argparse
import logging
import os
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from tfde_tpu_torch.checkpoint.manager import CheckpointManager
from tfde_tpu_torch.data import datasets
from tfde_tpu_torch.data.mlm import IGNORE_ID, MlmConfig, mask_tokens
from tfde_tpu_torch.models.bert import BertBase, bert_tiny_test
from tfde_tpu_torch.observability.tensorboard import SummaryWriter
from tfde_tpu_torch.ops.losses import masked_lm_loss
from tfde_tpu_torch.parallel.strategies import MultiWorkerMirroredStrategy
from tfde_tpu_torch.runtime.cluster import bootstrap, shutdown
from tfde_tpu_torch.training.lifecycle import _step_seed
from tfde_tpu_torch.training.optimizers import (
    adamw, warmup_cosine_decay_schedule)
from tfde_tpu_torch.training.step import init_state, make_custom_train_step
from tfde_tpu_torch.utils.devices import resolve_device

log = logging.getLogger("bert_mlm")


def mlm_loss_fn(model, batch, generator: Optional[torch.Generator] = None):
    """(loss, metrics) for `make_custom_train_step`. `grad_weight` carries
    the target count: the MLM loss normalises by it, so accumulation and
    data parallelism weight each microbatch and each rank by its own
    count to reproduce the full-batch update."""
    input_ids, labels = batch
    logits = model(input_ids, train=True, generator=generator)
    loss, acc = masked_lm_loss(logits, labels, IGNORE_ID)
    n_targets = (labels != IGNORE_ID).sum().float()
    return loss, {"mlm_accuracy": acc, "grad_weight": n_targets}


def batch_stream(tokens: np.ndarray, cfg: MlmConfig, global_batch: int,
                 seed: int):
    """Endless global batches (input_ids, labels): rows drawn with
    replacement and masked, from one generator (the JAX example's)."""
    rng = np.random.default_rng(seed)
    n = len(tokens)
    while True:
        idx = rng.integers(0, n, global_batch)
        yield mask_tokens(tokens[idx], cfg, rng)


def main(argv=None):
    """Train as the JAX example does; returns (state, last metrics)."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--batch-size", type=int, default=64,
                        help="per worker")
    parser.add_argument("--seq-len", type=int, default=128)
    parser.add_argument("--max-steps", type=int, default=1000)
    parser.add_argument("--learning-rate", type=float, default=1e-4)
    parser.add_argument("--warmup-steps", type=int, default=100)
    parser.add_argument("--train-examples", type=int, default=8192)
    parser.add_argument("--grad-accum", type=int, default=1,
                        help="sequential microbatches per optimizer update")
    parser.add_argument("--model-dir", type=str, default=None)
    parser.add_argument("--tiny", action="store_true",
                        help="the CI-sized model; its head dim 8 takes the "
                             "reference attention on either device")
    parser.add_argument("--remat", nargs="?", const="full", default=False,
                        choices=["full", "dots"],
                        help="checkpoint each block: bare --remat recomputes "
                             "everything; '--remat dots' saves the GEMMs' "
                             "outputs and recomputes the rest")
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--seed", type=int, default=0,
                        help="seeds the random weights")
    args = parser.parse_args(argv)

    info = bootstrap(device=args.device)
    device = resolve_device(args.device)
    global_batch = args.batch_size * max(info.num_processes, 1)
    model = (bert_tiny_test if args.tiny else BertBase)(
        device=device, seed=args.seed, remat=args.remat)
    vocab = model.vocab_size
    # the last id is [MASK], so the synthetic streams never produce it
    cfg = MlmConfig(vocab_size=vocab - 1, mask_id=vocab - 1)
    tokens = datasets.synthetic_tokens(args.train_examples, args.seq_len,
                                       vocab=vocab - 1)
    schedule = warmup_cosine_decay_schedule(
        0.0, args.learning_rate,
        warmup_steps=min(args.warmup_steps, max(args.max_steps - 1, 1)),
        decay_steps=args.max_steps)
    state = init_state(model, adamw(model, schedule, weight_decay=0.01))
    strategy = MultiWorkerMirroredStrategy()
    rank = 0 if not dist.is_initialized() else dist.get_rank()
    mngr = None
    if args.model_dir:
        mngr = CheckpointManager(os.path.join(args.model_dir, "checkpoints"),
                                 group=strategy.data_group)
        mngr.restore_latest(state)
    writer = (SummaryWriter(args.model_dir)
              if args.model_dir and rank == 0 else None)
    step_fn = make_custom_train_step(mlm_loss_fn, args.grad_accum,
                                     strategy=strategy, state=state)
    generator = torch.Generator(device=device)
    stream = batch_stream(tokens, cfg, global_batch, seed=0)
    start = state.step
    t0 = time.perf_counter()
    metrics = {}
    try:
        for step in range(start, args.max_steps):
            generator.manual_seed(_step_seed(0, state.step,
                                             strategy.data_rank()))
            state, metrics = step_fn(state, next(stream), generator)
            if (step + 1) % 100 == 0:
                vals = {k: float(v) for k, v in metrics.items()}  # syncs
                sps = 100 / (time.perf_counter() - t0)
                t0 = time.perf_counter()
                log.info("step %d: %s (%.2f steps/s)", step + 1, vals, sps)
                if writer is not None:
                    writer.scalars(step + 1, {**vals,
                                              "global_step/sec": sps})
            if mngr is not None and (step + 1) % 500 == 0:
                mngr.save(state)
        if mngr is not None:
            mngr.save(state)
            mngr.wait()
    finally:
        if mngr is not None:
            mngr.close()
        if writer is not None:
            writer.close()
    log.info("done at step %d (%s, global batch %d): loss %s", state.step,
             strategy.describe(), global_batch,
             f"{float(metrics['loss']):.4f}" if metrics else "n/a")
    return state, metrics


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, force=True)
    try:
        main()
    finally:
        shutdown()
