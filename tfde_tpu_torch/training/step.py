"""Train and eval steps — counterpart of `tfde_tpu/training/step.py`
(`init_state`, `make_train_step`, `make_eval_step`, `pad_batch_for_mesh`,
`make_custom_train_step`, `make_custom_eval_step`).

The JAX step is one compiled program over a mesh; here each runs eagerly
on the model's device. `make_train_step` is the classification step
under a data-parallel strategy (`parallel.strategies`: DDP, ZeRO-1 or
FSDP2); `make_custom_train_step` takes a user loss, on one device (the
GPT path) or under a strategy (the BERT path).

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

import contextlib
from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor

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
    is off by ~6e-6 relative, `torch.sum` by ~1e-7. FSDP's `DTensor`
    gradients add their local shards' squares, summed over the sharded
    mesh dims in one all-reduce (every rank calls it)."""
    tensors = list(tensors)
    whole = [t for t in tensors if not isinstance(t, DTensor)]
    sharded = [t for t in tensors if isinstance(t, DTensor)]
    squares = [torch.square(t.float()).sum() for t in whole]
    if sharded:
        mesh, placements = sharded[0].device_mesh, sharded[0].placements
        if any(t.device_mesh != mesh or t.placements != placements
               for t in sharded):
            raise NotImplementedError(
                "global_norm over DTensors of different layouts")
        part = torch.stack([torch.square(t.to_local().float()).sum()
                            for t in sharded]).sum()
        for dim, placement in enumerate(placements):
            if placement.is_shard():
                dist.all_reduce(part, group=mesh.get_group(dim))
        squares.append(part)
    return torch.sqrt(torch.stack(squares).sum())


def make_custom_train_step(loss_fn: Callable, grad_accum: int = 1,
                           strategy: Optional[Strategy] = None,
                           state: Optional[TrainState] = None):
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
    sync.

    Without a `strategy` the step runs the model on one device, on the
    batch as it is given. With one (and the `state` it lays out, as
    `make_train_step` does: `strategy.shard_update`, then
    `strategy.replicate`), the step runs the replicated module on this
    rank's rows: a host batch is the GLOBAL batch, a `Placed` batch this
    rank's rows already. The JAX step computes the loss over the global
    batch, so its normaliser is global: each rank's weights
    (``grad_weight``, 1 a microbatch without one) are summed over the
    data group, and rank r's loss is scaled by world x w_r / sum(w) (at
    `grad_accum` 1 before the backward; with accumulation the gradients
    are divided by the global sum after it), so that the data group's
    gradient average is the gradient of the global weighted mean even
    when the ranks hold different target counts. The metrics are the
    global weighted means, the same on every rank.
    """
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    module, group = None, None
    if strategy is not None:
        if state is None:
            raise ValueError("a strategy needs the state it lays out")
        strategy.shard_update(state)
        module = strategy.replicate(state.model)
        group = strategy.data_group
    world = 1 if group is None else dist.get_world_size(group)
    no_sync = getattr(module, "no_sync", None)

    def step(state: TrainState, batch, generator: Optional[torch.Generator]
             = None):
        model = state.model if module is None else module
        params = [p for p in state.model.parameters() if p.requires_grad]
        device = params[0].device
        leaves = batch if isinstance(batch, tuple) else (batch,)
        if strategy is not None:
            leaves = _to_device(strategy, leaves, device)
        state.tx.zero_grad(set_to_none=True)
        n = leaves[0].shape[0]
        if n % grad_accum:
            raise ValueError(f"batch {n} not divisible by grad_accum="
                             f"{grad_accum}")
        m = n // grad_accum
        one = torch.ones((), dtype=torch.float32, device=device)
        sums = None
        for i in range(grad_accum):
            micro = tuple(x[i * m:(i + 1) * m] for x in leaves)
            loss, metrics = loss_fn(
                model, micro if isinstance(batch, tuple) else micro[0],
                generator)
            metrics = dict(metrics)
            w = metrics.pop("grad_weight", None)
            if grad_accum == 1 and world == 1:
                w = one  # one microbatch is its own gradient
            elif w is None:
                w = one
            else:
                w = torch.as_tensor(w, dtype=torch.float32,
                                    device=device).detach()
            if grad_accum == 1 and world > 1:
                total = _sum_over(group, w.clone())
                scale = w * world / torch.where(total > 0, total, one)
            else:
                scale = w * world
            sync = (contextlib.nullcontext() if no_sync is None
                    or i == grad_accum - 1 else no_sync())
            with sync:
                (loss * scale).backward()
            row = torch.stack([loss.detach() * w, w] + [
                torch.as_tensor(v, dtype=torch.float32, device=device)
                .detach() * w for v in metrics.values()])
            sums = row if sums is None else sums + row
        sums = _sum_over(group, sums)
        inv = 1.0 / torch.where(sums[1] > 0, sums[1], one)
        for p in params:
            if p.grad is None:  # unused this step: a zero gradient, as JAX
                p.grad = torch.zeros_like(p)
            elif grad_accum > 1:
                p.grad.mul_(inv)
        out = {"loss": sums[0] * inv}
        out.update({k: v * inv for k, v in zip(metrics, sums[2:])})
        out.setdefault("grad_norm", global_norm([p.grad for p in params]))
        state.apply_gradients()
        return state, out

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
    strategy.shard_update(state)
    module = strategy.replicate(state.model)
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
    above one data-parallel rank: the custom eval step is single-device.
    """
    if strategy.batch_divisor > 1:
        raise NotImplementedError(
            "a custom eval_fn runs on one device only: the port's custom "
            "eval step is single-device (its data-parallel twin comes with "
            "the scale-out slice)")
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
