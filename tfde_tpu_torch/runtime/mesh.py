"""Device meshes — counterpart of `tfde_tpu/runtime/mesh.py`, on
`torch.distributed.device_mesh.DeviceMesh`.

The axis names and their canonical order (outermost first) are the JAX
package's. One process drives one device, so a mesh is laid over the
ranks of the default process group in rank order: the JAX mesh over
`jax.devices()` in process order. Only the ``data`` axis has a strategy
in the port so far (`parallel.strategies`); the others are validated and
laid out, and wait for their strategies.

With no process group the mesh has one rank. `make_mesh` then returns a
`LocalMesh`, which has the attributes the strategies read and no
process group, and never calls `init_process_group` itself: building the
group is `runtime.cluster.bootstrap`'s job (or the caller's).
"""

from __future__ import annotations

import dataclasses
import math
import socket
from typing import Mapping, Optional, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

# Canonical axis names, outermost-first.
AXIS_ORDER = ("pipe", "data", "fsdp", "expert", "seq", "tensor")


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Declarative mesh shape: axis name -> size; -1 means 'fill remaining'.

    Examples:
        MeshSpec({"data": -1})                      # pure DP over all ranks
        MeshSpec({"data": -1, "fsdp": 4})           # DP x FSDP
        MeshSpec({"data": 2, "seq": 2, "tensor": 2})  # DP x SP x TP
    """

    shape: Mapping[str, int]

    def __post_init__(self):
        unknown = set(self.shape) - set(AXIS_ORDER)
        if unknown:
            raise ValueError(f"Unknown mesh axes {unknown}; valid: {AXIS_ORDER}")
        fills = [n for n, s in self.shape.items() if s == -1]
        if len(fills) > 1:
            raise ValueError(f"At most one axis may be -1, got {fills}")

    def resolve(self, n_devices: int) -> dict[str, int]:
        """Concrete axis sizes for n_devices, in canonical order."""
        sizes = dict(self.shape)
        fixed = math.prod(s for s in sizes.values() if s != -1)
        if n_devices % fixed != 0:
            raise ValueError(
                f"mesh shape {dict(sizes)} does not divide {n_devices} devices"
            )
        for name, s in sizes.items():
            if s == -1:
                sizes[name] = n_devices // fixed
        if math.prod(sizes.values()) != n_devices:
            raise ValueError(
                f"mesh shape {sizes} (product {math.prod(sizes.values())}) "
                f"!= device count {n_devices}"
            )
        return {a: sizes[a] for a in AXIS_ORDER if a in sizes}


@dataclasses.dataclass(frozen=True)
class LocalMesh:
    """The one-rank mesh of a process without a process group: every axis
    has size 1. It reads like a `DeviceMesh` (`mesh_dim_names`, `shape`,
    `size`) and has no group to hand out."""

    mesh_dim_names: tuple

    @property
    def shape(self) -> tuple:
        return (1,) * len(self.mesh_dim_names)

    def size(self, mesh_dim: Optional[int] = None) -> int:
        return 1


def _device_type() -> str:
    """The default group's device type: 'cuda' under NCCL, else 'cpu'."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(shape: Mapping[str, int]) -> Union[DeviceMesh, LocalMesh]:
    """A mesh of the given shape over every rank of the default process
    group, axes in canonical order, ranks laid out in rank order (the last
    axis varies fastest). Every rank must call it: a mesh of more than one
    axis builds a group per axis. With no process group the shape must
    resolve to one rank, and the mesh is a `LocalMesh`."""
    if not dist.is_initialized():
        sizes = MeshSpec(shape).resolve(1)
        return LocalMesh(tuple(sizes))
    world = dist.get_world_size()
    sizes = MeshSpec(shape).resolve(world)
    ranks = torch.arange(world, dtype=torch.int).reshape(tuple(sizes.values()))
    return DeviceMesh(_device_type(), ranks, mesh_dim_names=tuple(sizes))


def data_parallel_mesh() -> Union[DeviceMesh, LocalMesh]:
    """Pure data-parallel mesh over every rank — the
    MultiWorkerMirroredStrategy analog."""
    return make_mesh({"data": -1})


def local_mirrored_mesh() -> Union[DeviceMesh, LocalMesh]:
    """Data-parallel mesh over this host's devices — the MirroredStrategy
    analog. One process drives one device, so this host's devices are the
    ranks on this host. Every rank of a group must call it (it gathers the
    host names); the group must lie on one host, since a mesh over a part
    of the group (one per host) is not ported."""
    if dist.is_initialized():
        hosts = [None] * dist.get_world_size()
        dist.all_gather_object(hosts, socket.gethostname())
        if len(set(hosts)) > 1:
            raise NotImplementedError(
                f"the process group spans {len(set(hosts))} hosts; a "
                f"MirroredStrategy per host is not ported — use "
                f"MultiWorkerMirroredStrategy to train across hosts")
    return data_parallel_mesh()
