"""Train and eval steps — counterpart of `tfde_tpu/training/step.py`
(`init_state`, `make_train_step`, `make_eval_step`, `pad_batch_for_mesh`,
`make_custom_train_step`, `make_custom_eval_step`).

The JAX step is one compiled program over a mesh; here each runs eagerly
on the model's device. `make_train_step` is the classification step
under a data-parallel strategy (`parallel.strategies`, DDP);
`make_custom_train_step` takes a user loss on one device (the GPT path).

Loss convention, the JAX package's: the mean over the global batch. Each
rank computes the mean over its equal share of the batch, and DDP's
average of the ranks' gradients is then the gradient of the global
mean.

A step takes a batch in one of two kinds. A host batch (numpy arrays or
CPU tensors) is the GLOBAL batch: the step keeps this rank's rows and
copies them to the model's device. A `data.device.Placed` batch, which
`device_prefetch` yields, is already this rank's rows on the model's
device, and the step uses it as it is.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from tfde_tpu_torch.data.device import Placed
from tfde_tpu_torch.ops import losses, metrics as metrics_lib
from tfde_tpu_torch.parallel.strategies import Strategy, check_ported
from tfde_tpu_torch.training.optimizers import Schedule
from tfde_tpu_torch.training.train_state import TrainState


def init_state(model: nn.Module, tx: torch.optim.Optimizer,
               schedule: Optional[Union[float, Schedule]] = None
               ) -> TrainState:
    """A TrainState at step 0 over the model's parameters as they are;
    `schedule` as `TrainState` takes it (None: the optimizer's own)."""
    return TrainState(model, tx, schedule)


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm), in
    fp32. The squares are summed by `torch.sum`: on the CPU,
    `torch.linalg.vector_norm` of a few hundred thousand fp32 elements
    is off by ~6e-6 relative, `torch.sum` by ~1e-7."""
    return torch.sqrt(torch.stack(
        [torch.square(t.float()).sum() for t in tensors]).sum())


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


def _to_device(strategy: Strategy, batch, device: torch.device) -> tuple:
    """This rank's rows of each leaf on `device`: a `Placed` batch as it is
    (it must lie on `device`), a host batch's global rows sliced and
    copied."""
    if isinstance(batch, Placed):
        for x in batch:
            if x.device != device:
                raise ValueError(f"a placed batch on {x.device} for a model "
                                 f"on {device}")
        return tuple(batch)
    return tuple(torch.as_tensor(strategy.local_rows(x), device=device)
                 for x in batch)


def _sum_over(group: Optional[dist.ProcessGroup], t: torch.Tensor
              ) -> torch.Tensor:
    """`t` summed over the ranks of `group` (itself without a group)."""
    if group is not None and dist.get_world_size(group) > 1:
        dist.all_reduce(t, group=group)
    return t


def make_train_step(strategy: Strategy, state: TrainState,
                    grad_accum: int = 1, comms=None, opt_sharding=None):
    """step(state, (images, labels), generator=None) -> (state, metrics):
    one synchronous data-parallel SGD step of a classifier.

    The model is wrapped once, here, by `strategy.replicate` (DDP over
    the ``data`` group). Each call takes the GLOBAL host batch (numpy
    arrays or tensors, labels [N, 1] or [N]) and keeps this rank's rows,
    or a `Placed` batch of this rank's rows; it runs the
    forward in training mode (BatchNorm on global-batch statistics over
    the ``data`` group, dropout from `generator`), the mean cross-entropy, DDP's averaged
    backward and the optimizer update. `metrics` are global-batch values,
    the same on every rank: ``loss`` and ``accuracy`` (one all-reduce of
    the two), and ``grad_norm``, the global norm of the averaged gradient.
    Metric values are detached tensors on the model's device: reading them
    is the caller's sync.

    The update's layout is the strategy's (`Strategy.shard_update`):
    replicated, or ZeRO-1 under `ParameterServerStrategy`. Only
    `grad_accum=1`, the fp32 gradient transport and those two layouts are
    ported; anything else raises.
    """
    if grad_accum != 1:
        raise NotImplementedError(
            f"grad_accum={grad_accum} is not ported for the data-parallel "
            f"classification step (make_custom_train_step takes it on one "
            f"device)")
    check_ported(comms, opt_sharding)
    module = strategy.replicate(state.model)
    strategy.shard_update(state)
    group = strategy.data_group
    params = [p for p in state.model.parameters() if p.requires_grad]
    device = params[0].device

    def step(state: TrainState, batch: Tuple, generator:
             Optional[torch.Generator] = None):
        images, labels = _to_device(strategy, batch, device)
        state.tx.zero_grad(set_to_none=True)
        logits = module(images, train=True, generator=generator,
                        group=group)
        loss = losses.sparse_categorical_crossentropy(logits, labels)
        loss.backward()
        grad_norm = global_norm([p.grad for p in params])
        pair = torch.stack([loss.detach(),
                            metrics_lib.accuracy(logits.detach(), labels)])
        world = 1 if group is None else dist.get_world_size(group)
        pair = _sum_over(group, pair) / world
        state.apply_gradients()
        return state, {"loss": pair[0], "accuracy": pair[1],
                       "grad_norm": grad_norm}

    return step


def make_eval_step(strategy: Strategy, state: TrainState):
    """step(state, (images, labels, mask)) -> {"loss_sum", "correct_sum",
    "weight"}: masked sums over the global batch (padded by
    `pad_batch_for_mesh` to a multiple of `strategy.batch_divisor`), each
    rank evaluating its rows (sliced from a host batch, or a `Placed`
    batch as it is) with the running BatchNorm statistics and the three
    sums added over the ranks. The caller accumulates them over the pass
    and divides once at the end."""
    group = strategy.data_group
    device = next(state.model.parameters()).device

    @torch.no_grad()
    def step(state: TrainState, batch: Tuple) -> dict:
        images, labels, mask = _to_device(strategy, batch, device)
        logits = state.model(images, train=False)
        per_ex = losses.softmax_cross_entropy_with_integer_labels(logits,
                                                                  labels)
        correct = (logits.argmax(dim=-1)
                   == labels.reshape(logits.shape[:-1])).float()
        mask = mask.float()
        sums = _sum_over(group, torch.stack(
            [(per_ex * mask).sum(), (correct * mask).sum(), mask.sum()]))
        return {"loss_sum": sums[0], "correct_sum": sums[1],
                "weight": sums[2]}

    return step


def make_custom_eval_step(strategy: Strategy, state: TrainState,
                          eval_fn: Callable):
    """step(state, batch) -> {metric: weighted sum, ..., "weight"} for a
    user metric function, the eval twin of `make_custom_train_step`, on
    one device.

    `eval_fn(model, batch, generator) -> {metric: batch mean}` has the
    loss's signature; it runs under `torch.no_grad` with `generator`
    None (an eval draws nothing). An optional ``"weight"`` entry is the
    batch's weight in the pass (e.g. a count of masked positions; by
    default the batch's leading dimension). The step returns each metric
    times the weight, and the weight, as fp32 tensors: the caller adds
    them over the pass and divides once. A batch is a `Placed` batch or a
    host batch, copied to the model's device. Raises NotImplementedError
    above one data-parallel rank: the port's custom step is single-device.
    """
    if strategy.batch_divisor > 1:
        raise NotImplementedError(
            "a custom eval_fn runs on one device only: the port's custom "
            "steps are single-device (the data-parallel custom step comes "
            "with the scale-out slice)")
    device = next(state.model.parameters()).device

    @torch.no_grad()
    def step(state: TrainState, batch) -> dict:
        batch = _to_device(strategy, batch if isinstance(batch, tuple)
                           else (batch,), device)
        metrics = dict(eval_fn(state.model, batch, None))
        weight = metrics.pop("weight", None)
        weight = (torch.tensor(float(batch[0].shape[0]), device=device)
                  if weight is None else
                  torch.as_tensor(weight, dtype=torch.float32, device=device))
        out = {k: torch.as_tensor(v, dtype=torch.float32, device=device)
               * weight for k, v in metrics.items()}
        out["weight"] = weight.float()
        return out

    return step


def pad_batch_for_mesh(batch: Tuple, divisor: int
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pad (images, labels) up to a multiple of the mesh batch divisor and
    append the validity mask consumed by the eval step."""
    images, labels = batch[0], batch[1]
    n = images.shape[0]
    padded = -(-n // divisor) * divisor
    mask = np.zeros((padded,), np.float32)
    mask[:n] = 1.0
    if padded != n:
        pad = [(0, padded - n)] + [(0, 0)] * (images.ndim - 1)
        images = np.pad(np.asarray(images), pad)
        labels = np.pad(np.asarray(labels),
                        [(0, padded - n)] + [(0, 0)] * (labels.ndim - 1))
    return images, labels, mask
