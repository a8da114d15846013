"""Estimator-style distributed MNIST with the BN-CNN — counterpart of
`examples/mnist_estimator.py` (the reference's
`mnist_keras_distributed.py`: cluster bootstrap, parameter-server
training, throttled eval, checkpoints, TensorBoard, the final serving
export; SURVEY.md §3.1).

- the flags of mnist_keras:33-65 (`--working-dir`, `--num-epochs`,
  `--batch-size`, `--learning-rate`, `--verbosity`), read with
  `parse_known_args`, plus `--no-tensorboard` and `--device` (CUDA unless
  ``cpu``);
- `bootstrap()` reads the cluster from the environment (mnist_keras:
  221-233) and builds the process group: NCCL on CUDA, gloo on the CPU;
- `ParameterServerStrategy` (ZeRO-1, synchronous: the JAX package's
  reading of the reference's PS training, SURVEY.md §7) with sgd(lr);
- `BatchNormCNN` with its summary printed first (mnist_keras:117);
  RunConfig cadences 100/100/500 (mnist_keras:246-248); an EvalSpec named
  'mnist-eval' with a 10 s delay and throttle and a
  `FinalExporter('exporter', (None, 784))` (mnist_keras:151-162,
  264-275); TensorBoard on the chief on ``$TB_PORT`` (mnist_keras:
  192-197, 277-280).

    python -m tfde_tpu_torch.mnist_estimator --working-dir D      # one GPU
    python -m tfde_tpu_torch.mnist_estimator --working-dir D --device cpu \\
        --num-epochs 0.01 --no-tensorboard
"""

from __future__ import annotations

import argparse
import logging

from tfde_tpu_torch.data import Dataset, datasets
from tfde_tpu_torch.export.serving import FinalExporter
from tfde_tpu_torch.models.cnn import BatchNormCNN
from tfde_tpu_torch.observability.tb_server import start_tensorboard
from tfde_tpu_torch.parallel.strategies import ParameterServerStrategy
from tfde_tpu_torch.runtime.cluster import bootstrap, shutdown
from tfde_tpu_torch.training import (
    Estimator, EvalSpec, RunConfig, TrainSpec, train_and_evaluate)
from tfde_tpu_torch.training.optimizers import sgd
from tfde_tpu_torch.utils.devices import resolve_device
from tfde_tpu_torch.utils.summary import model_summary


def get_args(argv=None):
    """The flags of mnist_keras_distributed.py:33-65, and --device."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument(
        "--working-dir", type=str, required=True,
        help="location to write checkpoints and export models")
    parser.add_argument(
        "--num-epochs", type=float, default=5,
        help="number of times to go through the data, default=5")
    parser.add_argument(
        "--batch-size", default=128, type=int,
        help="number of records to read during each training step, "
             "default=128")
    parser.add_argument(
        "--learning-rate", default=0.01, type=float,
        help="learning rate for gradient descent, default=.01")
    parser.add_argument(
        "--verbosity", choices=["DEBUG", "ERROR", "FATAL", "INFO", "WARN"],
        default="INFO")
    parser.add_argument(
        "--no-tensorboard", action="store_true",
        help="skip the in-process TensorBoard server")
    parser.add_argument("--device", type=str, default="cuda")
    args, _ = parser.parse_known_args(argv)  # extra flags pass (mnist_keras:64)
    return args


def input_fn(features, labels, batch_size, mode):
    """The pipeline of mnist_keras_distributed.py:123-148, as the JAX
    example has it: TRAIN shuffles the whole set (the reference's window
    of 1000, widened), repeats and batches; EVAL batches once."""
    ds = Dataset.from_tensor_slices((features, labels))
    if mode == "train":
        return ds.shuffle(len(features), seed=0).repeat().batch(
            batch_size, drop_remainder=True).prefetch(4)
    return ds.batch(batch_size)


def train_and_evaluate_main(args):
    """mnist_keras_distributed.py:200-283; returns (state, final eval)."""
    (train_images, train_labels), (test_images, test_labels) = (
        datasets.mnist(flatten=True))
    # int() fixes the reference's float step count (mnist_keras:219)
    train_steps = int(args.num_epochs * len(train_images) // args.batch_size)

    info = bootstrap(device=args.device)
    device = resolve_device(args.device)
    run_config = RunConfig(model_dir=args.working_dir, save_summary_steps=100,
                           log_step_count_steps=100,
                           save_checkpoints_steps=500)
    model = BatchNormCNN(device=device, seed=run_config.seed)
    print(model_summary(model))
    est = Estimator(model, sgd(model, args.learning_rate),
                    strategy=ParameterServerStrategy(), config=run_config)
    train_spec = TrainSpec(
        lambda: input_fn(train_images, train_labels, args.batch_size,
                         "train"), max_steps=train_steps)
    eval_spec = EvalSpec(
        lambda: input_fn(test_images, test_labels, args.batch_size, "eval"),
        steps=None, name="mnist-eval",
        exporters=[FinalExporter("exporter", (None, 28 * 28))],
        start_delay_secs=10, throttle_secs=10)
    if info.is_chief and not args.no_tensorboard:
        start_tensorboard(args.working_dir)
    try:
        return train_and_evaluate(est, train_spec, eval_spec)
    finally:
        est.close()


def main(argv=None):
    args = get_args(argv)
    logging.getLogger().setLevel(
        args.verbosity if args.verbosity != "WARN" else "WARNING")
    return train_and_evaluate_main(args)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, force=True)
    try:
        main()
    finally:
        shutdown()
