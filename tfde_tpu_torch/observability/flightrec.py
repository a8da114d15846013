"""Crash flight recorder: the last N structured events, dumped on death —
a copy of `tfde_tpu/observability/flightrec.py` (pure Python; the port
never imports the JAX package). The one change is `_host_id`: it reads
the torch.distributed rank where JAX reads `jax.process_index()`. A dump
of either package loads with the other's `load`.

A `kill -9` leaves zero forensic artifacts; a SIGTERM or an unhandled
exception leaves only whatever the logger happened to flush. The flight
recorder closes that gap for everything short of SIGKILL: every subsystem
that already emits spans also appends a structured event (step transitions,
checkpoint save/restore, serving admits, health beats, sentry trips) to a
bounded in-memory ring buffer — O(1) per event, no I/O on the hot path —
and the buffer is written atomically to
``<model_dir>/debug/flight_<host>_<pid>.jsonl`` when the process is about
to die: on SIGTERM, on an unhandled exception, or explicitly from the
supervisor's abort path. Post-mortems then exist even when the process died
mid-step, and `tools/obs_dump.py` pretty-prints them.

Design points:
- One default recorder per process (like the metric registry); `record()`
  is a deque append under a lock, cheap enough for per-step call sites.
- `arm(model_dir)` fixes the dump directory and installs the death hooks
  ONCE: a chaining SIGTERM handler (it dumps, then defers to whatever
  handler was installed before it — the preemption guard's checkpoint
  commit path keeps working, and the process still exits by signal) and a
  chaining `sys.excepthook`. Signal installation is main-thread-only and
  silently skipped elsewhere, mirroring the preemption guard.
- Dumps are atomic (tmp file + `os.replace`) and idempotent: the latest
  dump wins, so a SIGTERM dump followed by the excepthook firing does not
  interleave partial files.
- `load(path)` is the inverse — the replay surface tests and obs_dump use.
"""

from __future__ import annotations

import collections
import json
import logging
import os
import signal as _signal
import sys
import threading
import time
from typing import List, Optional

log = logging.getLogger(__name__)

DEFAULT_CAPACITY = 512


def _host_id() -> int:
    """This process's rank for the dump filename: the torch.distributed
    rank when a process group is already up, else the env contract, else
    0. Never *initializes* anything — a recorder must be armable before
    (or without) any process group."""
    dist = sys.modules.get("torch.distributed")
    if dist is not None:
        try:
            if dist.is_available() and dist.is_initialized():
                return int(dist.get_rank())
        except Exception:
            pass
    try:
        return int(os.environ.get("TFDE_PROCESS_ID")
                   or os.environ.get("TASK_INDEX") or 0)
    except ValueError:
        return 0


class FlightRecorder:
    """Bounded ring of event dicts. `record()` anywhere, `dump()` on death."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self._events: collections.deque = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._dump_dir: Optional[str] = None
        self._hooks_installed = False
        self._prev_sigterm = None
        self._prev_excepthook = None
        self.last_dump_path: Optional[str] = None

    @property
    def capacity(self) -> int:
        return self._events.maxlen  # type: ignore[return-value]

    def record(self, kind: str, **fields) -> None:
        """Append one event. `kind` names the event ('step', 'ckpt_save',
        'sentry_trip', ...); extra fields must be JSON-serializable."""
        ev = {"ts": time.time(), "kind": kind}
        ev.update(fields)
        with self._lock:
            self._events.append(ev)

    def events(self) -> List[dict]:
        """Oldest-to-newest copy of the ring."""
        with self._lock:
            return list(self._events)

    # -- arming --------------------------------------------------------------
    def arm(self, model_dir: str, install_handlers: bool = True) -> None:
        """Fix the dump directory to `<model_dir>/debug` and (once) install
        the SIGTERM + excepthook death hooks. Re-arming with a new
        model_dir just moves the dump target."""
        self._dump_dir = os.path.join(model_dir, "debug")
        self.record("armed", model_dir=model_dir, host=_host_id(),
                    pid=os.getpid())
        if install_handlers and not self._hooks_installed:
            self._install_hooks()

    def _install_hooks(self) -> None:
        self._hooks_installed = True
        self._prev_excepthook = sys.excepthook

        def excepthook(etype, value, tb):
            try:
                self.record("unhandled_exception", error=f"{etype.__name__}: {value}")
                self.dump("unhandled_exception")
            except Exception:
                pass
            (self._prev_excepthook or sys.__excepthook__)(etype, value, tb)

        sys.excepthook = excepthook

        if threading.current_thread() is not threading.main_thread():
            return  # signal API is main-thread-only; excepthook still armed

        def on_sigterm(signum, frame):
            try:
                self.record("sigterm", signum=signum)
                self.dump("sigterm")
            except Exception:
                pass
            prev = self._prev_sigterm
            if callable(prev):
                prev(signum, frame)
            elif prev == _signal.SIG_IGN:
                return
            else:  # SIG_DFL (or None): die by the signal's own semantics
                _signal.signal(signum, _signal.SIG_DFL)
                _signal.raise_signal(signum)

        try:
            self._prev_sigterm = _signal.signal(_signal.SIGTERM, on_sigterm)
        except (ValueError, OSError):  # exotic embedding; stay inert
            self._prev_sigterm = None

    # -- dumping -------------------------------------------------------------
    def dump_path(self) -> Optional[str]:
        if self._dump_dir is None:
            return None
        return os.path.join(
            self._dump_dir, f"flight_{_host_id()}_{os.getpid()}.jsonl"
        )

    def dump(self, reason: str = "manual") -> Optional[str]:
        """Atomically write the ring (plus a trailing 'dump' marker event)
        as JSONL. Safe to call repeatedly — the newest dump replaces the
        file whole, never interleaves. Returns the path (None when not
        armed with a dump dir)."""
        path = self.dump_path()
        if path is None:
            log.debug("flight recorder dump(%s): not armed; skipping", reason)
            return None
        self.record("dump", reason=reason)
        events = self.events()
        try:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                for ev in events:
                    f.write(json.dumps(ev, sort_keys=True, default=repr) + "\n")
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except OSError:
            log.exception("flight recorder dump to %s failed", path)
            return None
        self.last_dump_path = path
        return path


def load(path: str) -> List[dict]:
    """Parse a dumped flight file back into its event list (the replay
    inverse of `dump`). Tolerates a truncated final line — the one case a
    dying process can leave behind."""
    events: List[dict] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                events.append(json.loads(line))
            except json.JSONDecodeError:
                log.warning("flight file %s: skipping unparseable line", path)
    return events


_default = FlightRecorder()


def default_recorder() -> FlightRecorder:
    """The process-wide recorder every subsystem appends to by default."""
    return _default


def record(kind: str, **fields) -> None:
    _default.record(kind, **fields)


def arm(model_dir: str, install_handlers: bool = True) -> None:
    _default.arm(model_dir, install_handlers=install_handlers)


def dump(reason: str = "manual") -> Optional[str]:
    return _default.dump(reason)
