"""Trigger-driven serving profiles — the serving half of
`tfde_tpu/observability/profiler.py` on `torch.profiler`.

Live anomaly signals (an SLO burn-rate crossing in slo.py, a straggler
flag in aggregate.py, a coordinated broadcast over the push channel, an
operator's ``POST /profile``) funnel into a `ProfileTrigger` hub that
arms a bounded capture on whichever profiler is registered: in serving,
a `RoundWindowProfiler` over the batcher's decode rounds. Every closed
capture is recorded in a retention-bounded artifact index under
``<model_dir>/debug/profiles/``, stamped with the trigger reason, the
round range and the request trace ids that were in flight, as in JAX.

A window is one `torch.profiler.profile` run: CPU and CUDA activity when
the profiled batcher runs on a CUDA device, CPU activity on the CPU. It
opens at a decode-round boundary, closes `span` rounds later, and writes
a Chrome trace (``<logdir>/plugins/profile/rounds_<pid>_<n>.json``,
Perfetto / chrome://tracing loadable) that the artifact record names
(``trace_file``) beside the window's wall seconds. While it is open,
every span (spans.py) enters a `record_function` region of its name.

One torch profiler runs in a process at a time, as with `jax.profiler`:
arming claims the process's one window, and a second `arm` — another
replica of the same process included — returns False while the first is
armed or capturing (409 on ``POST /profile``). The round hook never
raises into the step loop: a profiler that fails to start or stop is
logged and the window released.

The training half (`StepWindowProfiler`, `profile_trace`, the
``TFDE_PROFILE`` window) is not ported yet (ROADMAP queue 1 item 4).
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import threading
import time
from typing import Callable, Dict, List, Optional

from tfde_tpu_torch import knobs

log = logging.getLogger(__name__)

# Capture-overhead histogram: the host cost of opening and closing a
# window (profiler start, and stop with its Chrome-trace export).
CAPTURE_HISTOGRAM = "profile/capture"

#: the process's one profiler window: the RoundWindowProfiler holding it
_WINDOW_LOCK = threading.Lock()
_WINDOW_OWNER = None


def _observe_capture(seconds: float) -> None:
    from tfde_tpu_torch.observability import metrics

    metrics.default_registry().histogram(CAPTURE_HISTOGRAM).observe(seconds)


def _claim_window(owner) -> bool:
    global _WINDOW_OWNER
    with _WINDOW_LOCK:
        if _WINDOW_OWNER is not None and _WINDOW_OWNER is not owner:
            return False
        _WINDOW_OWNER = owner
        return True


def _release_window(owner) -> None:
    global _WINDOW_OWNER
    with _WINDOW_LOCK:
        if _WINDOW_OWNER is owner:
            _WINDOW_OWNER = None


def _host() -> int:
    """The torch.distributed rank when a group of more than one process
    is up (the JAX record's `process_index` when `process_count > 1`),
    else 0."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        return int(dist.get_rank())
    return 0


def _start_trace(cuda: bool):
    """Open a torch profiler window; returns the running profile."""
    import torch

    t0 = time.perf_counter()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    _observe_capture(time.perf_counter() - t0)
    return prof


def _stop_trace(prof, path: str) -> None:
    """Close the window and write its Chrome trace to `path`."""
    t0 = time.perf_counter()
    prof.stop()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)
    _observe_capture(time.perf_counter() - t0)


# --------------------------------------------------------------------------
# Artifact index: <model_dir>/debug/profiles/
# --------------------------------------------------------------------------

PROFILES_SUBDIR = os.path.join("debug", "profiles")


class ProfileArtifacts:
    """Retention-bounded index of completed captures.

    One JSON file per capture under ``<model_dir>/debug/profiles/``,
    stamped with the trigger reason, capture kind, round range, and the
    request trace ids that were in flight. Retention
    (``TFDE_PROFILE_RETAIN``) bounds disk: the oldest index entries are
    pruned. The Chrome traces themselves live under the profiler's logdir
    and are not deleted here.
    """

    def __init__(self, model_dir: Optional[str], retain: Optional[int] = None):
        self._dir = (
            os.path.join(model_dir, PROFILES_SUBDIR) if model_dir else None
        )
        if retain is None:
            retain = knobs.env_int("TFDE_PROFILE_RETAIN", 8)
        self._retain = max(1, int(retain))
        self._seq = 0
        self._lock = threading.Lock()

    @property
    def dir(self) -> Optional[str]:
        return self._dir

    def record(
        self,
        reason: str,
        kind: str,
        start: Optional[int],
        stop: Optional[int],
        traces: Optional[List[str]] = None,
        logdir: Optional[str] = None,
        **extra,
    ) -> Optional[str]:
        """Write one capture record; returns its path (None when no dir)."""
        if self._dir is None:
            return None
        try:
            os.makedirs(self._dir, exist_ok=True)
            with self._lock:
                self._seq += 1
                seq = self._seq
            ts = time.time()
            safe = "".join(c if c.isalnum() or c in "-_" else "-" for c in reason)[:48]
            name = f"profile_{ts:017.6f}_{seq:04d}_{safe or 'capture'}.json"
            rec = {
                "reason": reason,
                "kind": kind,
                "start": start,
                "stop": stop,
                "traces": sorted(traces) if traces else [],
                "logdir": logdir,
                "host": _host(),
                "pid": os.getpid(),
                "unix_time": ts,
            }
            rec.update(extra)
            path = os.path.join(self._dir, name)
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(rec, f, indent=1, sort_keys=True)
            os.replace(tmp, path)
            self._prune()
            return path
        except OSError as e:  # index failure must never break the capture
            log.warning("profile artifact index write failed: %s", e)
            return None

    def _prune(self) -> None:
        entries = sorted(
            f for f in os.listdir(self._dir)
            if f.startswith("profile_") and f.endswith(".json")
        )
        for stale in entries[: max(0, len(entries) - self._retain)]:
            with contextlib.suppress(OSError):
                os.remove(os.path.join(self._dir, stale))


def list_artifacts(model_dir: str) -> List[dict]:
    """Load every capture record under <model_dir>/debug/profiles/,
    oldest first."""
    d = os.path.join(model_dir, PROFILES_SUBDIR)
    out: List[dict] = []
    if not os.path.isdir(d):
        return out
    for name in sorted(os.listdir(d)):
        if not (name.startswith("profile_") and name.endswith(".json")):
            continue
        try:
            with open(os.path.join(d, name)) as f:
                rec = json.load(f)
            rec["_file"] = name
            out.append(rec)
        except (OSError, ValueError):
            continue
    return out


# --------------------------------------------------------------------------
# Trigger hub
# --------------------------------------------------------------------------

# A sink arms a bounded capture: sink(reason, span, info) -> bool (armed).
TriggerSink = Callable[[str, int, dict], bool]


class ProfileTrigger:
    """Funnel for live anomaly signals -> bounded profile captures.

    SLO burn-rate crossings (slo.py) and straggler flags (aggregate.py)
    call ``trigger(reason, ...)``; registered sinks (a
    RoundWindowProfiler in serving, the aggregator's cross-host broadcast
    on the chief) arm the actual capture. Two rate limits keep
    auto-capture from thrashing the run:

    - global cooldown (``TFDE_PROFILE_COOLDOWN_S``): at most one armed
      capture per window, regardless of reason;
    - per-key dedupe (``TFDE_PROFILE_DEDUPE_S``): the *same* reason key
      can't re-arm until its dedupe window passes.

    Timestamps are consumed only when a sink actually armed — a refused
    trigger doesn't burn the budget, so the next anomaly still gets its
    evidence.
    """

    def __init__(
        self,
        cooldown_s: Optional[float] = None,
        dedupe_s: Optional[float] = None,
        enabled: Optional[bool] = None,
        clock=time.monotonic,
    ):
        if cooldown_s is None:
            cooldown_s = knobs.env_float("TFDE_PROFILE_COOLDOWN_S", 120.0)
        if dedupe_s is None:
            dedupe_s = knobs.env_float("TFDE_PROFILE_DEDUPE_S", 600.0)
        if enabled is None:
            enabled = knobs.env_flag("TFDE_PROFILE_TRIGGERS", True)
        self.cooldown_s = float(cooldown_s)
        self.dedupe_s = float(dedupe_s)
        self.enabled = bool(enabled)
        self._clock = clock
        self._lock = threading.Lock()
        self._sinks: Dict[str, TriggerSink] = {}
        self._last_fire: Optional[float] = None
        self._last_by_key: Dict[str, float] = {}

    def register(self, name: str, sink: TriggerSink) -> None:
        with self._lock:
            self._sinks[name] = sink

    def unregister(self, name: str) -> None:
        with self._lock:
            self._sinks.pop(name, None)

    def sinks(self) -> List[str]:
        with self._lock:
            return sorted(self._sinks)

    def trigger(
        self,
        reason: str,
        key: Optional[str] = None,
        span: Optional[int] = None,
        extra_sink: Optional[TriggerSink] = None,
        **info,
    ) -> bool:
        """Request a capture. Returns True when some sink armed one.

        ``key`` scopes dedupe (defaults to the reason); ``extra_sink`` lets
        a caller offer a capture mechanism without registering. ``info``
        rides along to sinks and into the flightrec breadcrumb.
        """
        if not self.enabled:
            return False
        if span is None:
            span = knobs.env_int("TFDE_PROFILE_SPAN", 8)
        span = max(1, int(span))
        key = key or reason
        now = self._clock()
        with self._lock:
            if self._last_fire is not None and now - self._last_fire < self.cooldown_s:
                return False
            last_key = self._last_by_key.get(key)
            if last_key is not None and now - last_key < self.dedupe_s:
                return False
            sinks = list(self._sinks.items())
        if extra_sink is not None:
            sinks = sinks + [("extra", extra_sink)]
        armed_by = []
        for name, sink in sinks:
            try:
                if sink(reason, span, dict(info)):
                    armed_by.append(name)
            except Exception as e:  # a broken sink must not mask the others
                log.warning("profile trigger sink %r failed: %s", name, e)
        if not armed_by:
            return False
        # consume the budget only on success so refusals don't starve the
        # next real anomaly
        with self._lock:
            self._last_fire = now
            self._last_by_key[key] = now
        log.warning(
            "profile trigger %r armed capture (span=%d) via %s",
            reason, span, ",".join(armed_by),
        )
        from tfde_tpu_torch.observability import flightrec, metrics

        metrics.default_registry().counter("profile/triggers").incr()
        flightrec.record(
            "profile_trigger", reason=reason, span=span,
            sinks=armed_by, **{k: v for k, v in info.items()
                               if isinstance(v, (str, int, float, bool))},
        )
        return True


_HUB: Optional[ProfileTrigger] = None
_HUB_LOCK = threading.Lock()


def hub() -> ProfileTrigger:
    """Process-wide trigger hub (lazily built from the TFDE_PROFILE_* knobs)."""
    global _HUB
    with _HUB_LOCK:
        if _HUB is None:
            _HUB = ProfileTrigger()
        return _HUB


def trigger(reason: str, **kwargs) -> bool:
    """Module-level convenience: hub().trigger(...)."""
    return hub().trigger(reason, **kwargs)


def reset_hub() -> None:
    """Drop the process hub (test hook; next hub() re-reads the knobs)."""
    global _HUB
    with _HUB_LOCK:
        _HUB = None


# --------------------------------------------------------------------------
# Serving-side: decode-round windows
# --------------------------------------------------------------------------


class RoundWindowProfiler:
    """Bounded capture over continuous-batcher decode rounds. There is no
    global step in serving, so windows are measured in decode rounds:
    ``arm(span)`` opens a torch profiler window at the next round
    boundary and closes it ``span`` rounds later, recording an artifact
    stamped with the round range and every request trace id that was in
    flight during the window (module docstring).

    Driven by the batcher: ``on_round(rounds, traces)`` once per step with
    the cumulative round count and the active trace ids. `device`: the
    profiled batcher's device; a CUDA device adds CUDA activity to the
    window.
    """

    def __init__(self, logdir: Optional[str],
                 artifacts: Optional[ProfileArtifacts] = None,
                 device=None):
        self._logdir = logdir
        self._artifacts = artifacts
        self._cuda = device is not None and str(device).startswith("cuda")
        self._lock = threading.Lock()
        self._armed_span = 0
        self._reason: Optional[str] = None
        self._active = False
        self._prof = None
        self._t_open = 0.0
        self._open_round: Optional[int] = None
        self._stop_round: Optional[int] = None
        self._traces: set = set()
        self.windows_traced = 0
        #: the newest closed window's Chrome trace (None before one)
        self.last_trace_file: Optional[str] = None

    @property
    def enabled(self) -> bool:
        return self._logdir is not None

    def arm(self, span: Optional[int] = None, reason: str = "manual") -> bool:
        """Arm a capture of the next `span` decode rounds. Refuses when a
        capture is already armed/active here or in another profiler of
        this process, or there is no logdir."""
        if span is None:
            span = knobs.env_int("TFDE_PROFILE_SPAN", 8)
        if span < 1:
            raise ValueError("span must be >= 1")
        with self._lock:
            if self._logdir is None or self._active or self._armed_span:
                return False
            if not _claim_window(self):
                return False
            self._armed_span = int(span)
            self._reason = str(reason)
        log.info("round profiler: armed %d-round capture (%s) -> %s",
                 span, reason, self._logdir)
        return True

    def trigger_sink(self, reason: str, span: int, info: dict) -> bool:
        """ProfileTrigger sink."""
        return self.arm(span=span, reason=reason)

    def on_round(self, rounds: int, traces=None) -> None:
        """Batcher hook: cumulative decode-round count after each step."""
        with self._lock:
            if self._active:
                if traces:
                    self._traces.update(traces)
                if rounds >= self._stop_round:
                    self._close_locked(rounds)
                return
            if self._armed_span and self._logdir is not None:
                try:
                    self._prof = _start_trace(self._cuda)
                except Exception:
                    log.exception("round profiler: the window did not open")
                    self._armed_span = 0
                    self._reason = None
                    _release_window(self)
                    return
                from tfde_tpu_torch.observability import spans

                spans.set_trace_active(True)
                self._active = True
                self._t_open = time.perf_counter()
                self._open_round = rounds
                self._stop_round = rounds + self._armed_span
                self._armed_span = 0
                if traces:
                    self._traces.update(traces)
                log.info("round profiler: trace open at round %d (until %d)",
                         rounds, self._stop_round)

    def _close_locked(self, rounds: int) -> None:
        from tfde_tpu_torch.observability import spans

        spans.set_trace_active(False)
        wall = time.perf_counter() - self._t_open
        self.windows_traced += 1
        path = os.path.join(
            self._logdir, "plugins", "profile",
            f"rounds_{os.getpid()}_{self.windows_traced}.json")
        try:
            _stop_trace(self._prof, path)
        except Exception:
            log.exception("round profiler: the window did not close cleanly")
            path = None
        self._prof = None
        self._active = False
        self.last_trace_file = path
        if self._artifacts is not None:
            self._artifacts.record(
                self._reason or "manual", "round",
                self._open_round, rounds,
                traces=list(self._traces), logdir=self._logdir,
                trace_file=path, wall_s=wall,
            )
        log.info("round profiler: trace complete at round %d (%s)",
                 rounds, self._reason)
        self._reason = None
        self._open_round = self._stop_round = None
        self._traces = set()
        _release_window(self)

    def close(self) -> None:
        with self._lock:
            if self._active:
                self._close_locked(self._stop_round or 0)
            self._armed_span = 0
            _release_window(self)
