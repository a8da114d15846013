"""The train step — counterpart of `tfde_tpu/training/step.py`
(`init_state`, `make_custom_train_step`), on one device.

The user owns the loss, the step owns differentiation, gradient
accumulation and the optimizer update. The JAX step is one compiled
program over a mesh; here it runs eagerly on the model's device, and
data parallelism (DDP) comes with a later slice.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from tfde_tpu_torch.training.optimizers import AdamW
from tfde_tpu_torch.training.train_state import TrainState


def init_state(model: nn.Module, tx: AdamW) -> TrainState:
    """A TrainState at step 0 over the model's parameters as they are."""
    return TrainState(model, tx, tx.schedule)


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm)."""
    return torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(t.float()) for t in tensors]))


def make_custom_train_step(loss_fn: Callable, grad_accum: int = 1):
    """step(state, batch, generator) -> (state, metrics) for a user loss.

    `loss_fn(model, batch, generator) -> (loss, metrics)`; every batch
    leaf (a tensor or a tuple of tensors) is [batch, ...]. `grad_accum=A`
    splits the batch into A sequential microbatches, microbatch i being
    rows [i m, (i + 1) m), and averages their gradients before the one
    update. A loss that returns ``"grad_weight"`` in its metrics (a
    data-dependent denominator, e.g. a masked-LM target count) has each
    microbatch weighted by it — gradients, loss and metrics — which
    restores the full-batch update; a zero weight sum gives a zero
    gradient, never NaN. `metrics` holds ``loss``, the loss's own metrics
    and ``grad_norm``, the global norm of the averaged gradients before
    the update (unless the loss returns its own). Metric values are
    detached tensors on the model's device: reading them is the caller's
    sync."""
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")

    def step(state: TrainState, batch, generator: Optional[torch.Generator]
             = None):
        model = state.model
        params = [p for p in model.parameters() if p.requires_grad]
        state.tx.zero_grad(set_to_none=True)
        leaves = batch if isinstance(batch, tuple) else (batch,)
        n = leaves[0].shape[0]
        if n % grad_accum:
            raise ValueError(f"batch {n} not divisible by grad_accum="
                             f"{grad_accum}")
        m = n // grad_accum
        loss_sum, metric_sums, wsum = 0.0, {}, 0.0
        for i in range(grad_accum):
            micro = tuple(x[i * m:(i + 1) * m] for x in leaves)
            loss, metrics = loss_fn(
                model, micro if isinstance(batch, tuple) else micro[0],
                generator)
            metrics = dict(metrics)
            w = metrics.pop("grad_weight", None)
            # one microbatch is its own gradient: no weight to divide out
            w = (1.0 if grad_accum == 1 or w is None
                 else torch.as_tensor(w, dtype=torch.float32).detach())
            (loss * w).backward()
            loss_sum = loss_sum + loss.detach() * w
            for k, v in metrics.items():
                metric_sums[k] = metric_sums.get(k, 0.0) + v.detach() * w
            wsum = wsum + w
        for p in params:
            if p.grad is None:  # unused this step: a zero gradient, as JAX
                p.grad = torch.zeros_like(p)
        if grad_accum > 1:
            # every microbatch weightless -> a clean zero update (the
            # accum=1 behaviour), not 0 * inf
            wsum = torch.as_tensor(wsum, dtype=torch.float32,
                                   device=params[0].device)
            inv = 1.0 / torch.where(wsum > 0, wsum, torch.ones_like(wsum))
            for p in params:
                p.grad.mul_(inv)
            loss_sum = loss_sum * inv
            metric_sums = {k: v * inv for k, v in metric_sums.items()}
        metric_sums.setdefault("grad_norm",
                               global_norm([p.grad for p in params]))
        state.apply_gradients()
        return state, {"loss": loss_sum, **metric_sums}

    return step
