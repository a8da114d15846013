"""Metrics — counterpart of `tfde_tpu/ops/metrics.py`: the
`metrics=['accuracy']` of the reference models. A whole-dataset eval
sums masked counts instead (`training.step.make_eval_step`)."""

from __future__ import annotations

import torch


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Fraction of correct argmax predictions; labels are integers with any
    trailing 1-dims ([N, 1] or [N])."""
    labels = labels.reshape(logits.shape[:-1])
    return (logits.argmax(dim=-1) == labels).float().mean()
