"""Train-state checkpointing with resume — counterpart of
`tfde_tpu/checkpoint/manager.py` (`CheckpointManager` :31).

The reference's checkpoint contract: the Estimator saves every
`save_checkpoints_steps` into `model_dir` (mnist_keras:245-248), and a
restarted process resumes from the newest checkpoint. Where the JAX
package writes the {step, params, batch_stats, opt_state} pytree with
Orbax, a checkpoint here is one file, ``<directory>/<step>/state.pt``,
written by `torch.save` and read by `torch.load(weights_only=True)`:

    {"step": int, "model": the model's state_dict (parameters and
     buffers: BatchNorm's running statistics), "optimizer": the
     optimizer's state_dict}

- Commit: a step is written into ``<directory>/<step>.tmp-<pid>`` and
  renamed to ``<directory>/<step>`` by `os.replace`, so a directory a
  crash left half-written is never read (only names of digits are steps).
- Ranks: the parameters are replicated, so rank 0 of `group` writes.
  The optimizer state is saved in the replicated layout: under ZeRO-1
  (`ParameterServerStrategy`) every rank joins the all-gather of the
  slices before rank 0's host copy, and on restore each rank keeps its
  slice, so a checkpoint moves between the mirrored strategies and
  ZeRO-1 either way. Every rank restores onto its own device
  (`map_location`). The ranks must share the directory, as the JAX
  package's ranks share theirs.
- Saves are asynchronous, the JAX default: `save` copies the state to host
  memory at once (the next step changes the parameters in place) and
  writes it on one background thread; `wait` joins the write and then,
  after a save, holds every rank of `group` at a barrier, so that no rank
  goes on (and reads the step) before rank 0 has committed it.

Not ported: the retry policy over remote file systems (``TFDE_RETRY_*``,
the resilience slice) and remote directories; ZeRO's packed optimizer
state (``opt_sharding='shard'``) and restores across world sizes (with
the packed layout, in the scale-out slice).
"""

from __future__ import annotations

import logging
import os
import shutil
import threading
from typing import TYPE_CHECKING, List, Optional

import torch
import torch.distributed as dist

if TYPE_CHECKING:
    from tfde_tpu_torch.training.train_state import TrainState

log = logging.getLogger(__name__)

STATE_FILE = "state.pt"


def _to_host(obj):
    """A copy of `obj` with every tensor copied to host memory."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _first_difference(saved: dict, state: "TrainState") -> Optional[str]:
    """The first place where a checkpoint's payload does not fit the live
    state's structure, as "<where> (<what>)", or None where it fits: the
    model's keys, shapes and dtypes; the optimizer's groups, their
    hyperparameter names and parameter counts, and the shape of every
    per-parameter tensor it saved (and, once the live optimizer holds
    state, the names of each parameter's entries)."""
    live = state.model.state_dict()
    model = saved["model"]
    for k in list(live) + [k for k in model if k not in live]:
        if k not in model:
            return f"model.{k} (not in the checkpoint)"
        if k not in live:
            return f"model.{k} (not in the model)"
        a, b = model[k], live[k]
        if a.shape != b.shape or a.dtype != b.dtype:
            return (f"model.{k} (saved {tuple(a.shape)} {a.dtype}, live "
                    f"{tuple(b.shape)} {b.dtype})")
    opt, live_opt = saved["optimizer"], state.tx.state_dict()
    groups, live_groups = opt["param_groups"], live_opt["param_groups"]
    if len(groups) != len(live_groups):
        return (f"optimizer.param_groups ({len(groups)} saved, "
                f"{len(live_groups)} live)")
    params = state.optimizer_params()
    for i, (g, lg) in enumerate(zip(groups, live_groups)):
        names = sorted(set(g) ^ set(lg))
        if names:
            return f"optimizer.param_groups[{i}].{names[0]}"
        if len(g["params"]) != len(lg["params"]):
            return (f"optimizer.param_groups[{i}].params ({len(g['params'])} "
                    f"saved, {len(lg['params'])} live)")
    for idx, entries in opt["state"].items():
        if not 0 <= idx < len(params):
            return f"optimizer.state[{idx}] (no such parameter)"
        if idx in live_opt["state"] and (set(entries)
                                         != set(live_opt["state"][idx])):
            return (f"optimizer.state[{idx}] (saved {sorted(entries)}, "
                    f"live {sorted(live_opt['state'][idx])})")
        for name, v in entries.items():
            if (isinstance(v, torch.Tensor) and v.dim()
                    and v.shape != params[idx].shape):
                return (f"optimizer.state[{idx}].{name} (saved "
                        f"{tuple(v.shape)}, parameter "
                        f"{tuple(params[idx].shape)})")
    return None


class CheckpointManager:
    """Checkpoints of a TrainState in `directory`: save, wait, the newest
    step, reload, restore (see the module docstring).

    `group` is the process group whose rank 0 writes and whose ranks meet
    at the barrier after a save; None for a process alone. `max_to_keep`
    committed steps are kept, the oldest removed first (None keeps all).
    """

    def __init__(self, directory: str, max_to_keep: Optional[int] = 5,
                 group: Optional[dist.ProcessGroup] = None):
        self._dir = directory
        self._keep = max_to_keep
        self._group = group
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._unsynced = False  # a save since the last barrier
        self._steps = self._scan()

    @property
    def directory(self) -> str:
        return self._dir

    def _rank(self) -> int:
        return 0 if self._group is None else dist.get_rank(self._group)

    def _scan(self) -> List[int]:
        """The committed steps on disk, in order."""
        try:
            names = os.listdir(self._dir)
        except (FileNotFoundError, NotADirectoryError):
            return []  # nothing committed (a save will say why it fails)
        return sorted(int(n) for n in names if n.isdigit() and os.path.exists(
            os.path.join(self._dir, n, STATE_FILE)))

    def _path(self, step: int) -> str:
        return os.path.join(self._dir, str(step), STATE_FILE)

    # -- save ---------------------------------------------------------------
    def save(self, state: "TrainState") -> bool:
        """Checkpoint `state` at its step; False when that step is on disk
        (or being written) already. Every rank of the group calls it."""
        step = int(state.step)
        with self._lock:
            if step in self._steps:
                return False
            self._steps = sorted(self._steps + [step])
        optimizer = state.optimizer_state_dict()  # ZeRO-1: gathers slices
        if self._rank() == 0:
            payload = {"step": step,
                       "model": _to_host(state.model.state_dict()),
                       "optimizer": _to_host(optimizer)}
            self._join()  # one write at a time
            self._thread = threading.Thread(
                target=self._write, args=(step, payload), daemon=True,
                name="tfde-torch-checkpoint")
            self._thread.start()
        self._unsynced = True
        log.info("checkpoint saved at step %d -> %s", step, self._dir)
        return True

    def _write(self, step: int, payload: dict) -> None:
        try:
            os.makedirs(self._dir, exist_ok=True)
            tmp = os.path.join(self._dir, f"{step}.tmp-{os.getpid()}")
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            with open(os.path.join(tmp, STATE_FILE), "wb") as f:
                torch.save(payload, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, os.path.join(self._dir, str(step)))
            if self._keep:
                for old in self._scan()[:-self._keep]:
                    shutil.rmtree(os.path.join(self._dir, str(old)),
                                  ignore_errors=True)
                    with self._lock:
                        self._steps = [s for s in self._steps if s != old]
        except BaseException as e:  # raised to the caller by wait()
            self._error = e

    def _join(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            e, self._error = self._error, None
            raise RuntimeError(f"checkpoint write into {self._dir} "
                               f"failed") from e

    def wait(self) -> None:
        """Block until the pending write has committed; after a save, hold
        every rank of the group at a barrier until rank 0 has."""
        self._join()
        if self._unsynced and self._group is not None:
            if dist.get_backend(self._group) == "nccl":
                dist.barrier(self._group,
                             device_ids=[torch.cuda.current_device()])
            else:
                dist.barrier(self._group)
        self._unsynced = False

    # -- restore ------------------------------------------------------------
    @property
    def latest_step(self) -> Optional[int]:
        """The newest step saved or on disk (None when there is none)."""
        with self._lock:
            return self._steps[-1] if self._steps else None

    def all_steps(self) -> List[int]:
        with self._lock:
            return list(self._steps)

    def reload(self) -> None:
        """Re-read the directory: an evaluator following a live trainer's
        directory sees the steps committed since."""
        self._join()
        with self._lock:
            self._steps = self._scan()

    def _load(self, step: int, device) -> dict:
        return torch.load(self._path(step), map_location=device,
                          weights_only=True)

    def restore_latest(self, state: "TrainState"
                       ) -> Optional["TrainState"]:
        """Restore the newest committed checkpoint into `state` in place —
        the model's parameters and buffers, then the optimizer, then the
        step — and return it; None when the directory has no checkpoint.
        Raises ValueError naming the first difference when the checkpoint
        does not fit the state's structure."""
        self._join()
        device = next(state.model.parameters()).device
        while True:
            steps = self._scan()
            if not steps:
                return None
            try:
                payload = self._load(steps[-1], device)
                break
            except FileNotFoundError:
                continue  # removed by max_to_keep since the scan: rescan
        where = _first_difference(payload, state)
        if where is not None:
            raise ValueError(
                f"checkpoint step {steps[-1]} in {self._dir} does not match "
                f"the current train state's structure at {where} — most "
                f"commonly the model or the optimizer configuration changed "
                f"since it was written. Resume with the original model and "
                f"optimizer, or clear the checkpoint directory to restart")
        state.model.load_state_dict(payload["model"])
        state.load_optimizer_state_dict(payload["optimizer"])
        state.step = int(payload["step"])
        with self._lock:
            self._steps = sorted(set(self._steps) | set(steps))
        log.info("restored checkpoint step %d from %s", state.step, self._dir)
        return state

    def close(self) -> None:
        self.wait()
