"""Multi-worker synchronous data-parallel MNIST — counterpart of
`examples/mnist_multiworker.py` (the reference's
`distributed_with_keras.py`).

- `bootstrap()` reads the cluster from the environment (`TF_CONFIG`;
  `CLUSTER_SPEC`/`TASK_INDEX`/`JOB_NAME`; or `TFDE_NUM_PROCESSES`/
  `TFDE_PROCESS_ID`/`TFDE_COORDINATOR`) and builds the process group:
  NCCL on CUDA, gloo on the CPU;
- per-worker batch 64, global batch 64 x the number of processes;
- `PlainCNN` under `MultiWorkerMirroredStrategy` (DDP), SGD at lr 0.001;
- epochs x steps-per-epoch steps (3 x 5 by default).

Every rank shuffles the training set with the same seeded numpy
permutation (a new one each pass) and takes its rows of each global
batch: the reference's `AutoShardPolicy.OFF`. Where the JAX example
trains through `Estimator.train` over a `Dataset` (a 10000-example
shuffle buffer, `.cache()`), this calls `make_train_step` in a loop: the
input pipeline and the Estimator come with a later slice, and so does
checkpointing (`--model-dir` raises until then).

    python -m tfde_tpu_torch.mnist_multiworker              # one GPU
    python -m tfde_tpu_torch.mnist_multiworker --device cpu
    TFDE_NUM_PROCESSES=2 TFDE_PROCESS_ID=<r> TFDE_COORDINATOR=host0:2222 \\
        python -m tfde_tpu_torch.mnist_multiworker          # on each host
"""

from __future__ import annotations

import argparse
import logging

import numpy as np

from tfde_tpu_torch.data import datasets
from tfde_tpu_torch.models.cnn import PlainCNN
from tfde_tpu_torch.parallel.strategies import MultiWorkerMirroredStrategy
from tfde_tpu_torch.runtime.cluster import bootstrap, shutdown
from tfde_tpu_torch.training.optimizers import sgd
from tfde_tpu_torch.training.step import init_state, make_train_step
from tfde_tpu_torch.utils.devices import resolve_device

log = logging.getLogger("mnist_multiworker")

BATCH_SIZE = 64  # per worker


def global_batches(images: np.ndarray, labels: np.ndarray, batch: int,
                   steps: int, seed: int = 0):
    """`steps` global batches of `batch` rows: passes over the data, each
    in the order of a fresh permutation from `seed`, the remainder of a
    pass dropped."""
    rng = np.random.default_rng(seed)
    per_pass = len(images) // batch
    order = None
    for i in range(steps):
        if i % per_pass == 0:
            order = rng.permutation(len(images))
        idx = order[(i % per_pass) * batch:(i % per_pass + 1) * batch]
        yield images[idx], labels[idx]


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--epochs", type=int, default=3)
    parser.add_argument("--steps-per-epoch", type=int, default=5)
    parser.add_argument("--learning-rate", type=float, default=0.001)
    parser.add_argument("--model-dir", type=str, default=None,
                        help="not ported yet: checkpointing comes with the "
                             "lifecycle slice")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    if args.model_dir is not None:
        raise NotImplementedError("--model-dir: checkpointing is not ported "
                                  "yet (it comes with the lifecycle slice)")

    info = bootstrap(device=args.device)
    device = resolve_device(args.device)
    global_batch = BATCH_SIZE * max(info.num_processes, 1)
    (train_x, train_y), _ = datasets.mnist(flatten=False)

    model = PlainCNN(device=device)
    state = init_state(model, sgd(model, args.learning_rate))
    strategy = MultiWorkerMirroredStrategy()
    step_fn = make_train_step(strategy, state)
    steps = args.epochs * args.steps_per_epoch
    metrics = {}
    for i, batch in enumerate(global_batches(train_x, train_y, global_batch,
                                             steps)):
        state, metrics = step_fn(state, batch)
        if (i + 1) % args.steps_per_epoch == 0:
            vals = {k: float(v) for k, v in metrics.items()}  # syncs
            log.info("epoch %d, step %d: %s", (i + 1) // args.steps_per_epoch,
                     i + 1, vals)
    log.info("done at step %d (%s, global batch %d)", state.step,
             strategy.describe(), global_batch)
    return state, {k: float(v) for k, v in metrics.items()}


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, force=True)
    try:
        main()
    finally:
        shutdown()
