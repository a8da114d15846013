"""Distribution strategies — counterpart of
`tfde_tpu/parallel/strategies.py`: the two mirrored (synchronous
data-parallel) strategies on `DistributedDataParallel`, and
`ParameterServerStrategy`, the same with ZeRO-1 optimizer state.

In the JAX package a strategy is sharding rules over a mesh and XLA
inserts the gradient `psum`. Here the strategy owns a mesh
(`runtime.mesh`) and `replicate` wraps the model in DDP over the mesh's
``data`` group, whose bucketed all-reduce averages the gradients during
the backward pass. Every rank sees the whole global batch and takes its
own rows, rank r rows [r n/R, (r+1) n/R): the JAX batch split over the
``data`` axis in process order, and the reference's
`AutoShardPolicy.OFF` (every worker iterates the same stream).
`shard_update` lays out the optimizer's state before the model is
wrapped: whole on every rank for the mirrored strategies, sliced over the
``data`` group for `ParameterServerStrategy`
(`training.train_state.ShardedUpdate`). `FSDPStrategy` shards the
parameters themselves with FSDP2 (`torch.distributed.fsdp.fully_shard`)
and the optimizer's state with them.

Not ported yet, and raising NotImplementedError: the int8 gradient
transport (``grad_transport='int8'``), ZeRO's packed weight-update
sharding (``opt_sharding='shard'``, the JAX `parallel/zero.py` layout),
and the other strategies (tensor, sequence, expert, pipeline).
They come with the scale-out slice (ROADMAP, queue 1, "Then"). The port
does not read ``$TFDE_GRAD_TRANSPORT`` or ``$TFDE_OPT_SHARDING`` either:
its only transport is fp32.
"""

from __future__ import annotations

from typing import Optional, Union

import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.nn.parallel import DistributedDataParallel

from tfde_tpu_torch.runtime import mesh as mesh_lib

Mesh = Union[DeviceMesh, mesh_lib.LocalMesh]

_LATER = "comes with the scale-out slice (ROADMAP, queue 1, 'Then')"


def check_ported(grad_transport=None, opt_sharding=None) -> None:
    """Raise for a gradient transport other than fp32 or a weight-update
    layout other than replicated: NotImplementedError for the JAX
    package's 'int8' and 'shard', ValueError for a name it does not
    know either."""
    if grad_transport not in (None, "fp32"):
        if grad_transport == "int8":
            raise NotImplementedError(
                f"grad_transport='int8' is not ported yet: it {_LATER}")
        raise ValueError(f"unknown grad_transport {grad_transport!r}")
    if opt_sharding not in (None, "replicated"):
        if opt_sharding == "shard":
            raise NotImplementedError(
                f"opt_sharding='shard' (ZeRO's packed layout) is not ported "
                f"yet: it {_LATER}")
        raise ValueError(f"unknown opt_sharding {opt_sharding!r}")


class Strategy:
    """Base: replicated parameters and optimizer state, the batch split
    over the ``data`` axis.

    `grad_transport` takes only 'fp32' (or None) and `opt_sharding` only
    'replicated' (or None); 'int8' and 'shard' are not ported yet.
    """

    def __init__(self, mesh: Optional[Mesh] = None, grad_transport=None,
                 opt_sharding=None):
        check_ported(grad_transport, opt_sharding)
        self._mesh = mesh

    @property
    def mesh(self) -> Mesh:
        if self._mesh is None:
            self._mesh = self._default_mesh()
        return self._mesh

    def _default_mesh(self) -> Mesh:
        return mesh_lib.data_parallel_mesh()

    def _axis_sizes(self) -> dict:
        return dict(zip(self.mesh.mesh_dim_names, self.mesh.shape))

    @property
    def num_replicas(self) -> int:
        return self.mesh.size()

    @property
    def batch_divisor(self) -> int:
        """Global batch sizes must divide by this: the ``data`` axis size."""
        return self._axis_sizes().get("data", 1)

    def data_rank(self) -> int:
        """This process's index along the ``data`` axis."""
        if isinstance(self.mesh, mesh_lib.LocalMesh):
            return 0
        return self.mesh.get_local_rank("data")

    def local_rows(self, x):
        """This rank's rows of a global batch leaf: [r n/R, (r+1) n/R)."""
        n, world = x.shape[0], self.batch_divisor
        if n % world:
            raise ValueError(f"global batch {n} is not divisible by the "
                             f"{world} data-parallel ranks")
        m = n // world
        r = self.data_rank()
        return x[r * m:(r + 1) * m]

    @property
    def data_group(self) -> Optional[dist.ProcessGroup]:
        """The process group of the ``data`` axis; None on a mesh without
        a group."""
        if isinstance(self.mesh, mesh_lib.LocalMesh):
            return None
        return self.mesh.get_group("data")

    def replicate(self, model: nn.Module) -> nn.Module:
        """The module the train step runs: `model` wrapped in DDP over the
        mesh's ``data`` group, or `model` itself on a mesh without a group.
        The train step hands the same group to the model's forward, whose
        BatchNorms normalise with global-batch statistics over it (the JAX
        package's default); DDP then need not broadcast buffers, which
        global statistics keep equal on every rank."""
        sizes = self._axis_sizes()
        if any(s > 1 for a, s in sizes.items() if a != "data"):
            raise NotImplementedError(
                f"{self.describe()}: only the 'data' axis is ported; "
                f"the others {_LATER}")
        group = self.data_group
        if group is None:
            return model
        dev = next(model.parameters()).device
        return DistributedDataParallel(
            model, device_ids=[dev.index] if dev.type == "cuda" else None,
            process_group=group, broadcast_buffers=False)

    def shard_update(self, state) -> None:
        """Lay out `state`'s optimizer for this strategy's update; the
        mirrored strategies keep it whole on every rank."""

    def describe(self) -> str:
        return f"{type(self).__name__}(mesh={self._axis_sizes()})"


class MirroredStrategy(Strategy):
    """Synchronous DP over this host's devices (`local_mirrored_mesh`)."""

    def _default_mesh(self) -> Mesh:
        return mesh_lib.local_mirrored_mesh()


class MultiWorkerMirroredStrategy(Strategy):
    """Synchronous DP over every rank of the cluster. Build it after
    `runtime.cluster.bootstrap()`, so that the mesh spans every process."""


class _Unported(Strategy):
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            f"{type(self).__name__} is not ported yet: it {_LATER}")


class ParameterServerStrategy(Strategy):
    """The parameter-server capability, synchronous: ZeRO-1 (JAX :192-212).

    The reference hosts variables on ps tasks that workers read and update
    over gRPC (tf2_mnist:189). Here, as in the JAX package, the hosting
    is of the optimizer state, sliced over the ``data`` group: the
    gradients are averaged by DDP as under MultiWorkerMirroredStrategy,
    each rank updates its slice of each parameter of at least
    `min_shard_elems` elements (and the whole of each smaller one), and
    an all-gather gives every rank the whole updated parameters. The math
    is the mirrored step's; the optimizer state a rank holds shrinks by
    the rank count for the sharded parameters. Parameters stay replicated,
    so a PS-trained model evaluates under either mirrored strategy.
    """

    def __init__(self, mesh: Optional[Mesh] = None,
                 min_shard_elems: int = 2**14, grad_transport=None,
                 opt_sharding=None):
        super().__init__(mesh, grad_transport=grad_transport,
                         opt_sharding=opt_sharding)
        self.min_shard_elems = min_shard_elems

    def shard_update(self, state) -> None:
        """ZeRO-1 over the ``data`` group (nothing to do at one rank)."""
        state.shard_optimizer(self.data_group, self.min_shard_elems)


class FSDPStrategy(Strategy):
    """Fully-sharded data parallelism on FSDP2 (JAX :511-539, BASELINE.json
    configs[3]): parameters, gradients and optimizer state sharded over
    the ``fsdp`` axis of a ``{"data": data, "fsdp": -1}`` mesh, and
    replicated over ``data`` (HSDP) when `data` > 1. The global batch
    splits over data x fsdp, rank r of the flattened mesh taking rows
    [r n/R, (r+1) n/R), as the JAX batch sharding over both axes does.

    `replicate` applies `fully_shard` to each `TransformerBlock` and then
    to the root: the forward all-gathers a block's parameters before it
    runs, the backward reduce-scatters its gradients (averaged over the
    ranks, in fp32: the parameters stay fp32 and the model's own `Dense`
    computes in bf16, so no `MixedPrecisionPolicy`). FSDP2 shards every
    parameter along dim 0; `min_shard_elems` (the JAX threshold below
    which a tensor stays whole) is accepted and changes nothing in the
    math. Parameters become `DTensor`s: `shard_update` moves the
    optimizer onto them, and `TrainState` reads and loads checkpoints in
    the replicated layout (`full_tensor`), so a checkpoint moves between
    FSDP and the mirrored strategies either way.
    """

    def __init__(self, mesh: Optional[Mesh] = None, data: int = 1,
                 min_shard_elems: int = 2**10, grad_transport=None,
                 opt_sharding=None):
        self._data = data
        self.min_shard_elems = min_shard_elems
        super().__init__(mesh, grad_transport=grad_transport,
                         opt_sharding=opt_sharding)

    def _default_mesh(self) -> Mesh:
        return mesh_lib.make_mesh({"data": self._data, "fsdp": -1})

    @property
    def batch_divisor(self) -> int:
        """The batch splits over data x fsdp: every rank of the mesh."""
        return self.mesh.size()

    def data_rank(self) -> int:
        """This process's index in the flattened data x fsdp mesh."""
        if isinstance(self.mesh, mesh_lib.LocalMesh):
            return 0
        sizes = self._axis_sizes()
        return (self.mesh.get_local_rank("data") * sizes["fsdp"]
                + self.mesh.get_local_rank("fsdp"))

    @property
    def data_group(self) -> Optional[dist.ProcessGroup]:
        """The group over which the batch is split: every rank (the mesh
        spans the default group, as `runtime.mesh.make_mesh` lays it)."""
        if isinstance(self.mesh, mesh_lib.LocalMesh):
            return None
        return dist.group.WORLD

    def replicate(self, model: nn.Module) -> nn.Module:
        """`model` with `fully_shard` applied to each TransformerBlock and
        to the root (once; a model sharded already is returned as it is);
        `model` itself on a mesh without a group."""
        from torch.distributed.fsdp import FSDPModule, fully_shard

        from tfde_tpu_torch.models.transformer import TransformerBlock

        if isinstance(self.mesh, mesh_lib.LocalMesh) or isinstance(
                model, FSDPModule):
            return model
        mesh = (self.mesh if self._axis_sizes()["data"] > 1
                else self.mesh["fsdp"])
        for mod in model.modules():
            if isinstance(mod, TransformerBlock):
                fully_shard(mod, mesh=mesh)
        fully_shard(model, mesh=mesh)
        return model

    def shard_update(self, state) -> None:
        """Shard the model (`replicate`) and move the optimizer onto its
        sharded parameters, slicing any state it already holds."""
        names = {id(p): n for n, p in state.model.named_parameters()}
        self.replicate(state.model)
        state.rebind_params(names)


class TensorParallelStrategy(_Unported):
    """Megatron-style tensor parallelism; not ported."""


class SequenceParallelStrategy(_Unported):
    """Sequence (ring) parallelism; not ported."""


class ExpertParallelStrategy(_Unported):
    """Expert parallelism for MoE layers; not ported."""


class PipelineParallelStrategy(_Unported):
    """Pipeline parallelism; not ported."""
