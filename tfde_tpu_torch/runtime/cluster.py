"""Cluster bootstrap — counterpart of `tfde_tpu/runtime/cluster.py`, on
`torch.distributed`.

The environment contract is the JAX package's, parsed by the same code:
``TF_CONFIG``; or ``CLUSTER_SPEC``/``TASK_INDEX``/``JOB_NAME``, written
back into the environment as ``TF_CONFIG``; or the native
``TFDE_NUM_PROCESSES``/``TFDE_PROCESS_ID``/``TFDE_COORDINATOR``, which
take precedence. Roles map onto ranks as there: ``master``/``chief`` ->
rank 0, ``worker`` i -> rank i (+1 when a master exists), ``ps`` entries
are dropped and a ``ps`` role is refused.

`bootstrap()` then builds the default process group once, where the JAX
package calls `jax.distributed.initialize`: NCCL when the device is CUDA,
gloo on the CPU, rendezvous through a TCP store on the coordinator
endpoint (`coordinator_endpoint`), rank = process id, world = process
count, with an explicit timeout. A one-process cluster builds no group.

Not ported yet: the retry of a racy first connect under the resilience
policy (``TFDE_RETRY_*``), the elastic re-bootstrap (the JAX
``bootstrap(force=True)``) and its survivor-safe abandon teardown, the
flight-recorder breadcrumbs and the ``cluster/world_size`` gauge; they
come with the resilience and observability slices.
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import logging
import os
from typing import Optional

import torch
import torch.distributed as dist

from tfde_tpu_torch import knobs
from tfde_tpu_torch.utils.devices import resolve_device

log = logging.getLogger(__name__)

_INITIALIZED = False
#: the ClusterInfo the last bootstrap() resolved — what the running
#: process group was built from
_LAST_INFO: Optional["ClusterInfo"] = None

#: how long a rank waits for the others at the rendezvous and in each
#: collective before it raises
DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)


@dataclasses.dataclass(frozen=True)
class ClusterInfo:
    """Resolved identity of this process within the training cluster."""

    num_processes: int
    process_id: int
    coordinator_address: Optional[str]
    job_type: str  # 'chief' | 'worker' | 'local'
    task_index: int

    @property
    def is_chief(self) -> bool:
        """Chief = process 0, the reference's `worker 0` / `master` role,
        which owns the host-side side effects (event files, export)."""
        return self.process_id == 0

    @property
    def is_distributed(self) -> bool:
        return self.num_processes > 1


def _parse_tf_config() -> Optional[dict]:
    """Parse TF_CONFIG if present."""
    raw = os.environ.get("TF_CONFIG")
    if not raw:
        return None
    try:
        cfg = json.loads(raw)
    except json.JSONDecodeError as e:
        # Fail loudly: silently degrading would fan a configured N-host job
        # out into N independent single-host jobs.
        raise ValueError(f"TF_CONFIG is set but is not valid JSON: {e}") from e
    if "cluster" not in cfg:
        return None
    return cfg


def _synthesize_tf_config() -> Optional[dict]:
    """CLUSTER_SPEC/TASK_INDEX/JOB_NAME -> TF_CONFIG dict, written back into
    the environment as the reference does."""
    raw = os.environ.get("CLUSTER_SPEC")
    if not raw:
        return None
    try:
        cluster_spec = json.loads(raw)
    except json.JSONDecodeError as e:
        raise ValueError(f"CLUSTER_SPEC is set but is not valid JSON: {e}") from e
    job_index = int(os.environ.get("TASK_INDEX", "0"))
    job_type = os.environ.get("JOB_NAME", "worker")
    cfg = {"cluster": cluster_spec, "task": {"type": job_type, "index": job_index}}
    os.environ["TF_CONFIG"] = json.dumps(cfg)
    log.info("Distribution enabled: %s", os.environ["TF_CONFIG"])
    return cfg


def _rank_from_tf_config(cfg: dict) -> tuple[int, int, str, int, Optional[str]]:
    """Map a TF_CONFIG cluster onto ranks: ps tasks are dropped (no
    parameter-server data plane), chief/master is rank 0, workers follow
    in index order. Returns (num_processes, process_id, job_type,
    task_index, coordinator)."""
    cluster = cfg["cluster"]
    task = cfg.get("task", {"type": "worker", "index": 0})
    job_type = task.get("type", "worker")
    task_index = int(task.get("index", 0))

    chief_hosts = cluster.get("chief", []) or cluster.get("master", [])
    worker_hosts = cluster.get("worker", [])
    ps_hosts = cluster.get("ps", [])
    if ps_hosts:
        log.info(
            "Cluster spec lists %d ps tasks; they are not ranked (the "
            "synchronous data-parallel build has no parameter-server role).",
            len(ps_hosts),
        )

    ranked_hosts = list(chief_hosts) + list(worker_hosts)
    num_processes = max(len(ranked_hosts), 1)

    if job_type in ("chief", "master"):
        process_id = 0
        norm_type = "chief"
    elif job_type == "worker":
        process_id = len(chief_hosts) + task_index
        norm_type = "chief" if (not chief_hosts and task_index == 0) else "worker"
    elif job_type == "ps":
        raise RuntimeError(
            "This process was launched with JOB_NAME=ps. This build has no "
            "parameter-server role: run only chief/worker tasks; they train "
            "synchronously, every rank holding the whole model."
        )
    else:
        process_id = task_index
        norm_type = job_type

    coordinator = ranked_hosts[0] if ranked_hosts else None
    return num_processes, process_id, norm_type, task_index, coordinator


def resolve_cluster() -> ClusterInfo:
    """Resolve cluster identity from the environment (the only side effect
    is CLUSTER_SPEC's TF_CONFIG written back)."""
    # Native contract takes precedence.
    if os.environ.get("TFDE_NUM_PROCESSES"):
        # an unparseable world size warns and drops to the TF_CONFIG path
        num = knobs.env_int("TFDE_NUM_PROCESSES")
        if num is not None:
            pid = knobs.env_int("TFDE_PROCESS_ID", 0)
            coord = knobs.env_str("TFDE_COORDINATOR")
            return ClusterInfo(num, pid, coord,
                               "chief" if pid == 0 else "worker", pid)

    cfg = _parse_tf_config() or _synthesize_tf_config()
    if cfg is None:
        log.info("Distribution is not enabled")
        return ClusterInfo(1, 0, None, "local", 0)

    num, pid, job_type, task_index, coord = _rank_from_tf_config(cfg)
    return ClusterInfo(num, pid, coord, job_type, task_index)


def coordinator_endpoint(coord: str, default_port: int = 8476) -> str:
    """host[:port] from the cluster spec -> the rendezvous endpoint.

    The spec port belongs to the application's own service, so the
    rendezvous listens on a derived port: spec port + 1011, wrapped to stay
    in range; `default_port` when the spec names none. Every process
    computes the same endpoint from the same spec. `TFDE_COORD_PORT`
    overrides when the derived port is taken.
    """
    tail = coord.rsplit("]")[-1]  # IPv6-bracket aware
    if ":" in tail:
        host, spec_port = coord.rsplit(":", 1)
        derived = int(spec_port) + 1011
        if derived > 65535:
            derived = int(spec_port) - 1011
    else:
        host, derived = coord, default_port
    port = knobs.env_int("TFDE_COORD_PORT", int(derived))
    return f"{host}:{port}"


def last_info() -> Optional[ClusterInfo]:
    """The ClusterInfo the last `bootstrap()` call resolved (None before
    the first bootstrap): the running topology, where `resolve_cluster()`
    reads the environment afresh."""
    return _LAST_INFO


def initialized() -> bool:
    """True while a process group this module built is up."""
    return _INITIALIZED


def shutdown() -> None:
    """Destroy the process group `bootstrap()` built, so that it can run
    again. Safe when nothing was built."""
    global _INITIALIZED
    if not _INITIALIZED:
        return
    if dist.is_initialized():
        dist.destroy_process_group()
    _INITIALIZED = False


def bootstrap(device=None) -> ClusterInfo:
    """Resolve the cluster and build the default process group if it has
    more than one process.

    `device` is the device this process trains on (`resolve_device`: CUDA
    unless ``"cpu"``): CUDA takes the NCCL backend and makes
    ``cuda:<process_id % local GPU count>`` the current device first; the
    CPU takes gloo. Every process must call it. Safe to call again: the
    group is built once (`shutdown()` first to build it anew). Each rank
    waits DEFAULT_TIMEOUT for the others.
    """
    global _INITIALIZED, _LAST_INFO
    info = resolve_cluster()
    if info.is_distributed and not _INITIALIZED:
        if dist.is_initialized():
            raise RuntimeError(
                "a default process group exists that bootstrap() did not "
                "build; destroy it first")
        dev = resolve_device(device)  # raises when CUDA is asked for and absent
        if dev.type == "cuda":
            if torch.device("cuda" if device is None else device).index is None:
                dev = torch.device(
                    "cuda", info.process_id % torch.cuda.device_count())
            torch.cuda.set_device(dev)
            backend = "nccl"
        else:
            backend = "gloo"
        if not info.coordinator_address:
            raise ValueError(
                f"a {info.num_processes}-process cluster needs a "
                f"coordinator address (TFDE_COORDINATOR or the cluster "
                f"spec's first host)")
        coord = coordinator_endpoint(info.coordinator_address)
        log.info(
            "init_process_group(%s, tcp://%s, world_size=%d, rank=%d)",
            backend, coord, info.num_processes, info.process_id,
        )
        dist.init_process_group(
            backend, init_method=f"tcp://{coord}",
            world_size=info.num_processes, rank=info.process_id,
            timeout=DEFAULT_TIMEOUT,
        )
        _INITIALIZED = True
    _LAST_INFO = info
    return info
