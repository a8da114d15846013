"""CIFAR-10 ResNet-50, multi-worker synchronous data parallelism —
counterpart of `examples/cifar10_resnet.py` (`augment` :40,
`make_train_dataset` :53, `main` :91), the scale-up of the reference's
`distributed_with_keras.py` recipe (BASELINE.json configs[2]).

- `bootstrap()` reads the cluster from the environment (as
  `mnist_multiworker`) and builds the process group: NCCL on CUDA, gloo
  on the CPU; global batch = per-worker batch x processes;
- the peak lr (``--learning-rate`` at global batch 1024) scaled linearly
  to the global batch, a linear warmup and a cosine decay over
  ``--max-steps`` (`warmup_cosine_decay_schedule`) into sgd with
  momentum 0.9, nesterov;
- `resnet50_cifar()` (bf16 trunk, fp32 master weights and head) under
  `MultiWorkerMirroredStrategy` (DDP, global-batch BatchNorm), trained by
  `Estimator.train` with `AutoShardPolicy.OFF`: every rank iterates the
  same stream and keeps its rows of each global batch;
- input: the native loader (`native.NativeBatchLoader`: shuffle, gather
  and prefetch in C++ threads) where it builds, else the Python
  `Dataset` pipeline; each batch augmented on the host (pad-4 random
  crop, horizontal flip). The log says which loader fed the run.

    python -m tfde_tpu_torch.cifar10_resnet --max-steps 200      # one GPU
    python -m tfde_tpu_torch.cifar10_resnet --device cpu --max-steps 2 \\
        --batch-size 2
    TFDE_NUM_PROCESSES=2 TFDE_PROCESS_ID=<r> TFDE_COORDINATOR=host0:2222 \\
        python -m tfde_tpu_torch.cifar10_resnet                   # each host

The JAX example's ``--fake-devices`` (JAX's virtual CPU devices) has no
counterpart: the port's CPU runs take ``--device cpu`` and gloo ranks.
"""

from __future__ import annotations

import argparse
import logging
from typing import Optional

import numpy as np

from tfde_tpu_torch import native
from tfde_tpu_torch.data import Dataset, datasets
from tfde_tpu_torch.data.pipeline import AutoShardPolicy
from tfde_tpu_torch.models.resnet import resnet50_cifar
from tfde_tpu_torch.parallel.strategies import MultiWorkerMirroredStrategy
from tfde_tpu_torch.runtime.cluster import bootstrap, shutdown
from tfde_tpu_torch.training import Estimator, RunConfig
from tfde_tpu_torch.training.optimizers import (
    sgd, warmup_cosine_decay_schedule)
from tfde_tpu_torch.utils.devices import resolve_device

log = logging.getLogger("cifar10_resnet")


def augment(rng: np.random.Generator, images: np.ndarray) -> np.ndarray:
    """Pad-4 random crop + horizontal flip (host-side, vectorized per
    batch): the JAX example's numpy, draw for draw."""
    n, h, w, _ = images.shape
    padded = np.pad(images, ((0, 0), (4, 4), (4, 4), (0, 0)), mode="reflect")
    ys = rng.integers(0, 9, n)[:, None, None]
    xs = rng.integers(0, 9, n)[:, None, None]
    rows = ys + np.arange(h)[None, :, None]
    cols = xs + np.arange(w)[None, None, :]
    out = padded[np.arange(n)[:, None, None], rows, cols]
    flip = rng.random(n) < 0.5
    return np.where(flip[:, None, None, None], out[:, :, ::-1], out)


def make_train_dataset(global_batch: int, seed: int = 0,
                       use_native: Optional[bool] = None):
    """Shuffle / repeat / batch at `global_batch` + per-batch augmentation,
    the same stream on every rank (AutoShardPolicy.OFF).

    `use_native` None takes the native loader where `native.available()`,
    else the Python `Dataset`; True asks for the native loader and raises
    RuntimeError when its library is unavailable (never the Python
    pipeline in its place); False takes the Python `Dataset`. The two
    paths draw different permutations (each the JAX example's)."""
    if use_native is None:
        use_native = native.available()
    if use_native and not native.available():
        raise RuntimeError(
            "use_native=True: the native loader's library did not build or "
            "load (see the WARNING from tfde_tpu_torch.native); pass "
            "use_native=None or False for the Python pipeline")
    (train_x, train_y), _ = datasets.cifar10()
    rng = np.random.default_rng(seed)
    if use_native:
        def gen():
            loader = native.NativeBatchLoader(
                [train_x, train_y], batch_size=global_batch, seed=seed,
                drop_remainder=True, num_threads=4, depth=4)
            try:
                for images, labels in loader:
                    # augment() makes fresh arrays; the labels still alias
                    # the loader's ring slot, so they are copied
                    yield augment(rng, images), labels.copy()
            finally:
                loader.close()
        return gen()

    def aug(images, labels):
        return augment(rng, images), labels

    return (Dataset.from_tensor_slices((train_x, train_y))
            .shuffle(len(train_x), seed=seed)
            .repeat()
            .batch(global_batch, drop_remainder=True)
            .map(aug))


def main(argv=None):
    """Train as the JAX example does; returns the final TrainState."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--batch-size", type=int, default=128,
                        help="per worker")
    parser.add_argument("--max-steps", type=int, default=1000)
    parser.add_argument("--learning-rate", type=float, default=0.4,
                        help="peak LR at global batch 1024; scaled linearly")
    parser.add_argument("--warmup-steps", type=int, default=100)
    parser.add_argument("--model-dir", type=str, default=None)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    info = bootstrap(device=args.device)
    device = resolve_device(args.device)
    global_batch = args.batch_size * max(info.num_processes, 1)

    peak_lr = args.learning_rate * global_batch / 1024.0
    schedule = warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=peak_lr,
        warmup_steps=min(args.warmup_steps, max(args.max_steps - 1, 1)),
        decay_steps=args.max_steps)
    model = resnet50_cifar(device=device)
    tx = sgd(model, schedule, momentum=0.9, nesterov=True)
    strategy = MultiWorkerMirroredStrategy()
    use_native = native.available()
    log.info("input: %s, global batch %d", "the native loader "
             "(NativeBatchLoader)" if use_native else "the Python Dataset "
             "pipeline (the native loader is unavailable)", global_batch)
    est = Estimator(model, tx, strategy=strategy,
                    config=RunConfig(model_dir=args.model_dir))
    try:
        state = est.train(
            lambda: make_train_dataset(global_batch, use_native=use_native),
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
