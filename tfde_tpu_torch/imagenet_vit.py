"""ImageNet ViT-B/16 under FSDP — counterpart of `examples/imagenet_vit.py`
(`make_train_dataset` :38, `main` :70; BASELINE.json configs[3]).

The reference's synchronous data-parallel recipe taken past replicated
weights: parameters, gradients and AdamW state shard over the ``fsdp``
axis of a ``{"data": --data, "fsdp": -1}`` mesh (`FSDPStrategy` on
FSDP2), and the global batch splits over data x fsdp.

- `bootstrap()` reads the cluster from the environment and builds the
  process group (NCCL on CUDA, gloo on the CPU); at one process there is
  no group, and the model trains unsharded, as under every strategy of
  the port; global batch = per-worker batch x processes;
- `ViT_B16` (224 px, 1000 classes, dropout 0.1, bf16 compute over fp32
  master weights, random weights from ``--seed``) or `vit_tiny_test`
  with ``--tiny``; every attention call runs the CUDA flash kernels
  (non-causal, 197 tokens);
- masked AdamW (``--weight-decay``) under a linear warmup and a cosine
  decay over ``--max-steps``, the classification loss, through
  `Estimator.train` with `AutoShardPolicy.OFF` (every rank iterates the
  same stream and keeps its rows);
- input: `datasets.imagenet` (a local ``imagenet.npz``, else the
  synthetic stand-in) through the native loader (`NativeBatchLoader`,
  copy=True, four threads, depth 4) where it builds, else the Python
  `Dataset` chain; the log says which fed the run.

    python -m tfde_tpu_torch.imagenet_vit --max-steps 100           # one GPU
    python -m tfde_tpu_torch.imagenet_vit --tiny --device cpu \\
        --image-size 32 --max-steps 2 --batch-size 16 --train-examples 64
    TFDE_NUM_PROCESSES=2 TFDE_PROCESS_ID=<r> TFDE_COORDINATOR=host0:2222 \\
        python -m tfde_tpu_torch.imagenet_vit                       # each host

``--remat [full|dots]`` checkpoints each encoder block (the flash forward
runs again in the backward). The JAX example's ``--fake-devices`` is not
ported; an unknown flag is an error.
"""

from __future__ import annotations

import argparse
import logging
from typing import Optional

from tfde_tpu_torch import native
from tfde_tpu_torch.data import Dataset, datasets
from tfde_tpu_torch.data.pipeline import AutoShardPolicy
from tfde_tpu_torch.models.vit import ViT_B16, vit_tiny_test
from tfde_tpu_torch.parallel.strategies import FSDPStrategy
from tfde_tpu_torch.runtime.cluster import bootstrap, shutdown
from tfde_tpu_torch.training import Estimator, RunConfig
from tfde_tpu_torch.training.optimizers import (
    adamw, warmup_cosine_decay_schedule)
from tfde_tpu_torch.utils.devices import resolve_device

log = logging.getLogger("imagenet_vit")


def make_train_dataset(global_batch: int, image_size: int, n: int,
                       num_classes: int, seed: int = 0,
                       use_native: Optional[bool] = None):
    """Shuffle / repeat / batch at `global_batch` over the (synthetic or
    local) ImageNet arrays, the same stream on every rank. At 224 px a
    row is 588 KB, and the batch gather is memory bandwidth: the native
    loader's GIL-free threads are the hot path. `use_native` None takes
    it where `native.available()`, else the Python `Dataset`; True asks
    for it and raises RuntimeError when its library is unavailable."""
    if use_native is None:
        use_native = native.available()
    if use_native and not native.available():
        raise RuntimeError(
            "use_native=True: the native loader's library did not build or "
            "load (see the WARNING from tfde_tpu_torch.native); pass "
            "use_native=None or False for the Python pipeline")
    (train_x, train_y), _ = datasets.imagenet(
        n_train=n, n_test=1, side=image_size, num_classes=num_classes)
    if use_native:
        # copy=True: the yielded views alias the loader's ring slots
        return native.NativeBatchLoader(
            [train_x, train_y], batch_size=global_batch, seed=seed,
            drop_remainder=True, num_threads=4, depth=4, copy=True)
    return (Dataset.from_tensor_slices((train_x, train_y))
            .shuffle(len(train_x), seed=seed)
            .repeat()
            .batch(global_batch, drop_remainder=True))


def main(argv=None):
    """Train as the JAX example does; returns the final TrainState."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--batch-size", type=int, default=256,
                        help="per worker")
    parser.add_argument("--max-steps", type=int, default=1000)
    parser.add_argument("--learning-rate", type=float, default=1e-3)
    parser.add_argument("--weight-decay", type=float, default=0.05)
    parser.add_argument("--warmup-steps", type=int, default=100)
    parser.add_argument("--image-size", type=int, default=224)
    parser.add_argument("--train-examples", type=int, default=4096,
                        help="synthetic-set size; real imagenet.npz "
                             "overrides")
    parser.add_argument("--model-dir", type=str, default=None)
    parser.add_argument("--data", type=int, default=1,
                        help="size of the 'data' mesh axis; 'fsdp' fills "
                             "the rest")
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
    schedule = warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=args.learning_rate,
        warmup_steps=min(args.warmup_steps, max(args.max_steps - 1, 1)),
        decay_steps=args.max_steps)
    num_classes = 10 if args.tiny else 1000
    if args.tiny:
        model = vit_tiny_test(num_classes=num_classes,
                              image_size=args.image_size, device=device,
                              seed=args.seed, remat=args.remat)
    else:
        model = ViT_B16(num_classes=num_classes, dropout_rate=0.1,
                        image_size=args.image_size, device=device,
                        seed=args.seed, remat=args.remat)
    tx = adamw(model, schedule, weight_decay=args.weight_decay)
    strategy = FSDPStrategy(data=args.data)
    use_native = native.available()
    log.info("input: %s, global batch %d", "the native loader "
             "(NativeBatchLoader)" if use_native else "the Python Dataset "
             "pipeline (the native loader is unavailable)", global_batch)
    est = Estimator(model, tx, strategy=strategy,
                    config=RunConfig(model_dir=args.model_dir))
    try:
        state = est.train(
            lambda: make_train_dataset(global_batch, args.image_size,
                                       args.train_examples, num_classes,
                                       use_native=use_native),
            max_steps=args.max_steps, shard_policy=AutoShardPolicy.OFF)
    finally:
        est.close()
    log.info("done at step %d (%s): loss %.4f", state.step,
             strategy.describe(), float(est.metrics["loss"]))
    return state


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, force=True)
    try:
        main()
    finally:
        shutdown()
