"""TF2-style Estimator MNIST — counterpart of `examples/mnist_tf2.py` (the
reference's `tf2_mnist_distributed.py`, SURVEY.md §3.3).

- the constants BATCH_SIZE=128 and LEARNING_RATE=1e-4
  (tf2_mnist:33-35);
- `ParameterServerStrategy()` (tf2_mnist:189): ZeRO-1, synchronous;
- BatchNormCNN through `train_and_evaluate` with a FinalExporter
  (tf2_mnist:205-241), the model_dir '/tmp/mode' of tf2_mnist:209 as the
  default of `--model-dir`;
- `--custom-loop`: the reference's unused hand-written `model_fn`
  (tf2_mnist:65-91) alive, as in the JAX example: PlainCNN trained by
  `make_train_step` over `device_prefetch` of the global batches;
- `--max-steps` (default one epoch; 100 for the custom loop) and
  `--device` (CUDA unless ``cpu``).

    python -m tfde_tpu_torch.mnist_tf2 --model-dir D              # one GPU
    python -m tfde_tpu_torch.mnist_tf2 --device cpu --custom-loop --max-steps 5
"""

from __future__ import annotations

import argparse
import logging

from tfde_tpu_torch.data import Dataset, datasets, device_prefetch
from tfde_tpu_torch.data.pipeline import AutoShardPolicy
from tfde_tpu_torch.export.serving import FinalExporter
from tfde_tpu_torch.models.cnn import BatchNormCNN, PlainCNN
from tfde_tpu_torch.parallel.strategies import ParameterServerStrategy
from tfde_tpu_torch.runtime.cluster import bootstrap, shutdown
from tfde_tpu_torch.training import (
    Estimator, EvalSpec, RunConfig, TrainSpec, train_and_evaluate)
from tfde_tpu_torch.training.optimizers import sgd
from tfde_tpu_torch.training.step import init_state, make_train_step
from tfde_tpu_torch.utils.devices import resolve_device
from tfde_tpu_torch.utils.summary import model_summary

log = logging.getLogger("mnist_tf2")

BATCH_SIZE = 128       # tf2_mnist:33
LEARNING_RATE = 1e-4   # tf2_mnist:35


def input_fn(features, labels, batch_size, mode):
    """tf2_mnist_distributed.py:38-63 (the pipeline of mnist_keras)."""
    ds = Dataset.from_tensor_slices((features, labels))
    if mode == "train":
        return ds.shuffle(len(features), seed=0).repeat().batch(
            batch_size, drop_remainder=True).prefetch(4)
    return ds.batch(batch_size)


def custom_train_loop(steps: int = 100, device=None):
    """The reference's unused model_fn path (tf2_mnist:65-91): PlainCNN,
    sgd(LEARNING_RATE), `steps` global batches of BATCH_SIZE through
    `device_prefetch` (every rank its rows) into `make_train_step`, whose
    loss is the mean over the global batch (the reference's per-example
    sum times 1 / BATCH_SIZE). Returns the final TrainState."""
    device = resolve_device(device)
    strategy = ParameterServerStrategy()
    (tx, ty), _ = datasets.mnist(flatten=False)
    ds = (Dataset.from_tensor_slices((tx, ty)).shuffle(len(tx), seed=0)
          .repeat().batch(BATCH_SIZE, drop_remainder=True))
    model = PlainCNN(device=device)
    state = init_state(model, sgd(model, LEARNING_RATE))
    step_fn = make_train_step(strategy, state)
    it = iter(ds)
    feed = device_prefetch((next(it) for _ in range(steps)), strategy,
                           device, policy=AutoShardPolicy.OFF)
    metrics = None
    for batch in feed:
        state, metrics = step_fn(state, batch)
    log.info("custom loop done: step=%d loss=%.4f", state.step,
             float(metrics["loss"]))
    return state


def main(argv=None):
    """The custom loop's TrainState with --custom-loop, else (state, the
    final eval metrics) of train_and_evaluate."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--model-dir", type=str, default="/tmp/mode")  # tf2_mnist:209
    parser.add_argument("--max-steps", type=int, default=None)
    parser.add_argument("--custom-loop", action="store_true")
    parser.add_argument("--device", type=str, default="cuda")
    args, _ = parser.parse_known_args(argv)

    logging.getLogger().setLevel(logging.INFO)  # tf2_mnist:187
    bootstrap(device=args.device)
    if args.custom_loop:
        return custom_train_loop(
            100 if args.max_steps is None else args.max_steps, args.device)

    device = resolve_device(args.device)
    strategy = ParameterServerStrategy()  # tf2_mnist:189
    (train_images, train_labels), (test_images, test_labels) = (
        datasets.mnist(flatten=True))  # tf2_mnist:191-200
    train_steps = (len(train_images) // BATCH_SIZE if args.max_steps is None
                   else args.max_steps)  # tf2_mnist:203
    model = BatchNormCNN(device=device)
    print(model_summary(model))  # tf2_mnist:143
    est = Estimator(model, sgd(model, LEARNING_RATE), strategy=strategy,
                    config=RunConfig(model_dir=args.model_dir))
    try:
        return train_and_evaluate(  # tf2_mnist:214-241
            est,
            TrainSpec(lambda: input_fn(train_images, train_labels,
                                       BATCH_SIZE, "train"),
                      max_steps=train_steps),
            EvalSpec(lambda: input_fn(test_images, test_labels, BATCH_SIZE,
                                      "eval"),
                     steps=None, name="mnist-eval",
                     exporters=[FinalExporter("exporter", (None, 28 * 28))],
                     start_delay_secs=10, throttle_secs=10))
    finally:
        est.close()


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, force=True)
    try:
        main()
    finally:
        shutdown()
