"""Train state — counterpart of `tfde_tpu/training/train_state.py`.

The JAX `TrainState` is an immutable pytree {step, params, opt_state}
that `apply_gradients` replaces. Here the parameters live in the model
(fp32 master weights, cast to the compute dtype inside each layer) and
the moments in the torch optimizer, so the state is a small mutable
holder and `apply_gradients` updates it in place. A model's BatchNorm
running statistics are buffers of the model (the JAX state's
`batch_stats`).

Under `ParameterServerStrategy` the update is ZeRO-1 (`ShardedUpdate`):
the parameters stay whole on every rank, and each rank keeps optimizer
state only for its slice of each sharded parameter. The JAX package gets
the same layout from a PartitionSpec on the optimizer state, and XLA's
reduce-scatter and all-gather; here the update does the slicing and the
all-gather itself.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Union

import torch
import torch.distributed as dist
from torch import nn

from tfde_tpu_torch.parallel.sharding import shard_dims
from tfde_tpu_torch.training.optimizers import Schedule, as_schedule


def opt_state_bytes(tx: torch.optim.Optimizer) -> int:
    """Bytes of this rank's per-parameter optimizer state (momentum,
    moments): every tensor of at least one dimension in `tx.state`. The
    scalar step counters are left out (torch's Adam keeps one a parameter,
    optax one in all)."""
    return sum(v.numel() * v.element_size() for entries in tx.state.values()
               for v in entries.values()
               if isinstance(v, torch.Tensor) and v.dim())


class ShardedUpdate:
    """ZeRO-1 over `group`: rank r of R owns slice r (of R equal slices,
    along the dim `parallel.sharding.shard_dims` picks) of each parameter
    of at least `min_elems` elements, and its optimizer updates a
    contiguous buffer holding that slice in the parameter's place; smaller
    parameters it updates whole, as every rank does. After each update an
    all-gather over `group` writes the slices back into the parameters,
    which stay whole and equal on every rank.

    The gradients must already be averaged over the group (DDP's
    all-reduce): each rank takes its slice of the whole gradient. The
    slice buffers are refreshed from the parameters before every update,
    so a parameter loaded or restored in place is seen. Optimizer state
    the optimizer already holds for a sharded parameter is sliced, so a
    restored replicated state carries on."""

    def __init__(self, model: nn.Module, tx: torch.optim.Optimizer,
                 group: dist.ProcessGroup, min_elems: int):
        self.group = group
        self.world = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        dims = shard_dims(model.named_parameters(), self.world, min_elems)
        dim_of = {id(p): dims[n] for n, p in model.named_parameters()}
        #: every optimized parameter, whole, in the optimizer's order
        self.params: List[torch.Tensor] = []
        #: (index in `params`, parameter, dim, this rank's slice buffer)
        self.slots = []
        for g in tx.param_groups:
            for j, p in enumerate(g["params"]):
                i = len(self.params)
                self.params.append(p)
                d = dim_of.get(id(p))
                if d is None:
                    continue
                shard = self._slice(p, d).clone()
                if p in tx.state:
                    tx.state[shard] = self._slice_entries(tx.state.pop(p), p, d)
                g["params"][j] = shard
                self.slots.append((i, p, d, shard))

    def _slice(self, t: torch.Tensor, d: int) -> torch.Tensor:
        k = t.shape[d] // self.world
        return t.detach().narrow(d, self.rank * k, k)

    def _slice_entries(self, entries: dict, p: torch.Tensor, d: int) -> dict:
        """An optimizer state entry of whole parameter `p` cut to this
        rank's slice (contiguous copies); scalars as they are."""
        return {k: (self._slice(v, d).clone()
                    if isinstance(v, torch.Tensor) and v.shape == p.shape
                    else v) for k, v in entries.items()}

    def _gather(self, shard: torch.Tensor, d: int) -> torch.Tensor:
        parts = [torch.empty_like(shard) for _ in range(self.world)]
        dist.all_gather(parts, shard.contiguous(), group=self.group)
        return torch.cat(parts, dim=d)

    def stage(self) -> None:
        """Before the optimizer step: each slice buffer takes the
        parameter's current values and its slice of the gradient."""
        for _, p, d, shard in self.slots:
            shard.copy_(self._slice(p, d))
            shard.grad = self._slice(p.grad, d).contiguous()

    @torch.no_grad()
    def gather(self) -> None:
        """After the optimizer step: every parameter whole again, from the
        ranks' updated slices (one all-gather a sharded parameter)."""
        for _, p, d, shard in self.slots:
            p.copy_(self._gather(shard, d))
            shard.grad = None

    def full_state_dict(self, tx: torch.optim.Optimizer) -> dict:
        """`tx.state_dict()` as the replicated update would hold it: each
        sharded entry gathered whole. A collective: every rank calls it."""
        sd = tx.state_dict()
        state = dict(sd["state"])
        for i, _, d, shard in self.slots:
            if i in state:
                state[i] = {k: (self._gather(v, d)
                                if isinstance(v, torch.Tensor)
                                and v.shape == shard.shape else v)
                            for k, v in state[i].items()}
        return {"state": state, "param_groups": sd["param_groups"]}

    def load_full_state_dict(self, tx: torch.optim.Optimizer, sd: dict
                             ) -> None:
        """Load a replicated-layout optimizer state dict, each rank keeping
        its slice of every sharded entry."""
        state = dict(sd["state"])
        for i, p, d, _ in self.slots:
            if i in state:
                state[i] = self._slice_entries(state[i], p, d)
        tx.load_state_dict({"state": state,
                            "param_groups": sd["param_groups"]})


class TrainState:
    """`step` (updates applied so far), the model, the optimizer `tx` (any
    torch optimizer over the model's parameters) and the lr schedule: a
    schedule of the update count, a number (a constant schedule), or None
    for the schedule the port's optimizers carry (`tx.schedule`).
    `sharded` is the ZeRO-1 update once `shard_optimizer` has installed
    it, else None."""

    def __init__(self, model: nn.Module, tx: torch.optim.Optimizer,
                 schedule: Optional[Union[float, Schedule]] = None):
        self.step = 0
        self.model = model
        self.tx = tx
        self.schedule = as_schedule(tx.schedule if schedule is None
                                     else schedule)
        self.sharded: Optional[ShardedUpdate] = None

    def shard_optimizer(self, group: Optional[dist.ProcessGroup],
                        min_elems: int) -> None:
        """Make the update ZeRO-1 over `group` (`ShardedUpdate`); nothing
        to do without a group, at one rank, or when it already is."""
        if (self.sharded is None and group is not None
                and dist.get_world_size(group) > 1):
            self.sharded = ShardedUpdate(self.model, self.tx, group,
                                         min_elems)

    def optimizer_params(self) -> List[torch.Tensor]:
        """The optimized parameters, whole, in the optimizer's order."""
        if self.sharded is not None:
            return list(self.sharded.params)
        return [p for g in self.tx.param_groups for p in g["params"]]

    def optimizer_state_dict(self) -> Dict:
        """The optimizer's state dict in the replicated layout (a
        collective under ZeRO-1: every rank calls it)."""
        if self.sharded is not None:
            return self.sharded.full_state_dict(self.tx)
        return self.tx.state_dict()

    def load_optimizer_state_dict(self, sd: Dict) -> None:
        """Load a replicated-layout optimizer state dict (each rank keeps
        its slices under ZeRO-1)."""
        if self.sharded is not None:
            self.sharded.load_full_state_dict(self.tx, sd)
        else:
            self.tx.load_state_dict(sd)

    def apply_gradients(self) -> "TrainState":
        """One optimizer update from the gradients held in the parameters'
        `.grad`: the lr of update `step` is `schedule(step)` (optax's
        count), then `step` goes up by one and the gradients are
        cleared."""
        lr = float(self.schedule(self.step))
        for group in self.tx.param_groups:
            group["lr"] = lr
        if self.sharded is not None:
            self.sharded.stage()
        self.tx.step()
        if self.sharded is not None:
            self.sharded.gather()
            self.model.zero_grad(set_to_none=True)
        self.tx.zero_grad(set_to_none=True)
        self.step += 1
        return self
