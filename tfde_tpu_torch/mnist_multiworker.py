"""Multi-worker synchronous data-parallel MNIST — counterpart of
`examples/mnist_multiworker.py` (the reference's
`distributed_with_keras.py`).

- `bootstrap()` reads the cluster from the environment (`TF_CONFIG`;
  `CLUSTER_SPEC`/`TASK_INDEX`/`JOB_NAME`; or `TFDE_NUM_PROCESSES`/
  `TFDE_PROCESS_ID`/`TFDE_COORDINATOR`) and builds the process group:
  NCCL on CUDA, gloo on the CPU;
- per-worker batch 64, global batch 64 x the number of processes
  (dwk:12-15);
- the dataset scaled, cached and shuffled with a 10000-example buffer
  (dwk:18-30), repeated and batched at the global batch;
- `PlainCNN` under `MultiWorkerMirroredStrategy` (DDP), SGD at lr 0.001,
  trained by `Estimator.train` with `AutoShardPolicy.OFF` (dwk:54-57):
  every rank iterates the same stream and keeps its rows of each global
  batch;
- epochs x steps-per-epoch steps (3 x 5 by default); with `--model-dir`
  the Estimator checkpoints into DIR/checkpoints and a second run resumes
  there and does only the steps left (max_steps is absolute).

    python -m tfde_tpu_torch.mnist_multiworker              # one GPU
    python -m tfde_tpu_torch.mnist_multiworker --device cpu --model-dir D
    TFDE_NUM_PROCESSES=2 TFDE_PROCESS_ID=<r> TFDE_COORDINATOR=host0:2222 \\
        python -m tfde_tpu_torch.mnist_multiworker          # on each host
"""

from __future__ import annotations

import argparse
import logging

import numpy as np

from tfde_tpu_torch.data import Dataset, datasets
from tfde_tpu_torch.data.pipeline import AutoShardPolicy
from tfde_tpu_torch.models.cnn import PlainCNN
from tfde_tpu_torch.parallel.strategies import MultiWorkerMirroredStrategy
from tfde_tpu_torch.runtime.cluster import bootstrap, shutdown
from tfde_tpu_torch.training import Estimator, RunConfig
from tfde_tpu_torch.training.optimizers import sgd
from tfde_tpu_torch.utils.devices import resolve_device

log = logging.getLogger("mnist_multiworker")

BUFFER_SIZE = 10000  # dwk:12
BATCH_SIZE = 64  # per worker, dwk:13


def global_batches(images: np.ndarray, labels: np.ndarray, batch: int,
                   steps: int, seed: int = 0):
    """`steps` global batches of `batch` rows: passes over the data, each
    in the order of a fresh permutation from `seed`, the remainder of a
    pass dropped. The batches of `chip_smoke.py`'s dp phase, which times
    the step loop without the pipeline and the Estimator."""
    rng = np.random.default_rng(seed)
    per_pass = len(images) // batch
    order = None
    for i in range(steps):
        if i % per_pass == 0:
            order = rng.permutation(len(images))
        idx = order[(i % per_pass) * batch:(i % per_pass + 1) * batch]
        yield images[idx], labels[idx]


def make_datasets_unbatched() -> Dataset:
    """MNIST -> scale -> cache -> shuffle (dwk:18-30)."""
    (train_x, train_y), _ = datasets.mnist(flatten=False)

    def scale(image, label):  # dwk:20-23 (already in [0, 1] when synthetic)
        return image.astype("float32"), label

    return (Dataset.from_tensor_slices((train_x, train_y)).map(scale).cache()
            .shuffle(BUFFER_SIZE, seed=0))


def main(argv=None):
    """Train as the reference does; returns the final TrainState and the
    last step's metrics as floats."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--epochs", type=int, default=3)             # dwk:63
    parser.add_argument("--steps-per-epoch", type=int, default=5)    # dwk:63
    parser.add_argument("--learning-rate", type=float, default=0.001)  # dwk:42
    parser.add_argument("--model-dir", type=str, default=None)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    info = bootstrap(device=args.device)
    device = resolve_device(args.device)
    global_batch = BATCH_SIZE * max(info.num_processes, 1)  # dwk:15

    strategy = MultiWorkerMirroredStrategy()
    train_ds = make_datasets_unbatched().repeat().batch(
        global_batch, drop_remainder=True)
    model = PlainCNN(device=device)
    est = Estimator(model, sgd(model, args.learning_rate), strategy=strategy,
                    config=RunConfig(model_dir=args.model_dir))
    try:
        state = est.train(lambda: train_ds,
                          max_steps=args.epochs * args.steps_per_epoch,
                          shard_policy=AutoShardPolicy.OFF)  # dwk:55-57
    finally:
        est.close()
    metrics = {k: float(v) for k, v in est.metrics.items()}
    log.info("done at step %d (%s, global batch %d): %s", state.step,
             strategy.describe(), global_batch, metrics)
    return state, metrics


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, force=True)
    try:
        main()
    finally:
        shutdown()
