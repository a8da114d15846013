"""Serving SLO tracking: TTFT/TPOT attainment and burn rate — a copy
of `tfde_tpu/observability/slo.py`; its burn-rate crossing triggers the
port's profiler hub (observability/profiler.py).

The serving comparison literature reports latency SLO attainment — the
fraction of requests whose time-to-first-token (TTFT) and
time-per-output-token (TPOT) land under a target — as the headline
serving metric, and SRE practice alerts on BURN RATE rather than raw
attainment: how fast the error budget is being consumed,

    burn = (1 - window_attainment) / (1 - objective)

so burn 1.0 means "exactly on budget", 10 means "budget gone in a tenth
of the window". Two windows (fast + slow) distinguish a blip from a
sustained regression.

`SLOTracker` lives in the Router (the client-observed vantage point:
TTFT includes queueing, placement, re-routes, and the primed hand-off),
publishes ``slo/*`` gauges into the metrics registry — so they ride the
existing ``/metrics`` exposition and the cluster push loop for free —
and its `summary()` is embedded in the Router's ``/replicas`` table.
Targets come from the constructor or the environment
(``TFDE_SLO_TTFT_MS`` / ``TFDE_SLO_TPOT_MS`` / ``TFDE_SLO_OBJECTIVE``).
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Dict, Optional, Sequence

from tfde_tpu_torch import knobs
from tfde_tpu_torch.observability import metrics

DEFAULT_TTFT_MS = 500.0
DEFAULT_TPOT_MS = 200.0
DEFAULT_OBJECTIVE = 0.99
#: fast window catches a live incident; slow window catches a grind
DEFAULT_WINDOWS = (300.0, 3600.0)
#: per-metric sample ring bound — at 10k rps nobody wants this unbounded
MAX_SAMPLES = 65536
#: a burn-threshold crossing needs at least this many in-window samples
#: before it can trigger a capture — one slow request at cold start is not
#: an incident
MIN_BURN_SAMPLES = 8


def _env_float(name: str, default: float) -> float:
    # the port's knob reader: a non-numeric value raises (knobs.py)
    return float(knobs.env_float(name, default))


class SLOTracker:
    """Sliding-window attainment + burn-rate accounting for one serving
    endpoint. Thread-safe; `record()` is called from request handler
    threads, `summary()` from status endpoints."""

    def __init__(self, ttft_target_ms: Optional[float] = None,
                 tpot_target_ms: Optional[float] = None,
                 objective: Optional[float] = None,
                 windows: Sequence[float] = DEFAULT_WINDOWS,
                 registry: Optional[metrics.Registry] = None,
                 clock=time.monotonic):
        self.ttft_target_ms = float(
            ttft_target_ms if ttft_target_ms is not None
            else _env_float("TFDE_SLO_TTFT_MS", DEFAULT_TTFT_MS))
        self.tpot_target_ms = float(
            tpot_target_ms if tpot_target_ms is not None
            else _env_float("TFDE_SLO_TPOT_MS", DEFAULT_TPOT_MS))
        obj = (objective if objective is not None
               else _env_float("TFDE_SLO_OBJECTIVE", DEFAULT_OBJECTIVE))
        # clamp away the burn-rate pole at objective == 1.0
        self.objective = min(max(float(obj), 0.0), 0.9999)
        self.windows = tuple(float(w) for w in windows)
        self._reg = registry or metrics.default_registry()
        self._clock = clock
        self._lock = threading.Lock()
        # per metric: ring of (t, ok) + cumulative totals
        self._samples: Dict[str, collections.deque] = {
            "ttft": collections.deque(maxlen=MAX_SAMPLES),
            "tpot": collections.deque(maxlen=MAX_SAMPLES),
        }
        self._total = {"ttft": 0, "tpot": 0}
        self._ok = {"ttft": 0, "tpot": 0}
        # burn-rate capture trigger: fire on the upward crossing of the
        # fast-window burn past TFDE_PROFILE_BURN_THRESHOLD (edge-detected
        # per metric so a sustained burn triggers once, not per request)
        self.burn_threshold = _env_float("TFDE_PROFILE_BURN_THRESHOLD", 10.0)
        self._burning = {"ttft": False, "tpot": False}
        self._publish_targets()

    # -- ingest --------------------------------------------------------------
    def record(self, ttft_ms: Optional[float] = None,
               tpot_ms: Optional[float] = None) -> None:
        """Account one finished request (either latency may be absent —
        a 1-token response has no TPOT) and refresh the gauges."""
        now = self._clock()
        with self._lock:
            if ttft_ms is not None:
                self._note("ttft", now, float(ttft_ms) <= self.ttft_target_ms)
            if tpot_ms is not None:
                self._note("tpot", now, float(tpot_ms) <= self.tpot_target_ms)
        self._publish()

    def _note(self, metric: str, now: float, ok: bool) -> None:
        self._samples[metric].append((now, ok))
        self._total[metric] += 1
        self._ok[metric] += 1 if ok else 0

    # -- queries -------------------------------------------------------------
    def attainment(self, metric: str,
                   window: Optional[float] = None) -> Optional[float]:
        """Fraction of requests under target — over a trailing window in
        seconds, or since startup when `window` is None. None before the
        first sample."""
        with self._lock:
            if window is None:
                total, ok = self._total[metric], self._ok[metric]
            else:
                cut = self._clock() - window
                rows = [okf for (t, okf) in self._samples[metric] if t >= cut]
                total, ok = len(rows), sum(rows)
        if total == 0:
            return None
        return ok / total

    def burn_rate(self, metric: str, window: float) -> Optional[float]:
        att = self.attainment(metric, window)
        if att is None:
            return None
        return (1.0 - att) / (1.0 - self.objective)

    def window_stats(self, metric: str, window: float):
        """(in-window sample count, attainment or None) — callers that
        act on a burn rate (the router's brownout) need the count to
        apply the same MIN_BURN_SAMPLES guard the capture trigger uses:
        one slow request at cold start is not an incident."""
        with self._lock:
            cut = self._clock() - window
            rows = [ok for (t, ok) in self._samples[metric] if t >= cut]
        if not rows:
            return 0, None
        return len(rows), sum(rows) / len(rows)

    def summary(self) -> dict:
        """The /replicas embed: targets, lifetime attainment, and burn
        per window for both latency SLOs."""
        out: dict = {
            "objective": self.objective,
            "ttft_target_ms": self.ttft_target_ms,
            "tpot_target_ms": self.tpot_target_ms,
            "windows_s": list(self.windows),
        }
        for metric in ("ttft", "tpot"):
            out[f"{metric}_requests"] = self._total[metric]
            out[f"{metric}_attainment"] = self.attainment(metric)
            out[f"{metric}_burn_rate"] = {
                f"{int(w)}s": self.burn_rate(metric, w) for w in self.windows
            }
        return out

    # -- exposition ----------------------------------------------------------
    def _publish_targets(self) -> None:
        self._reg.gauge("slo/objective").set(self.objective)
        self._reg.gauge("slo/ttft_target_ms").set(self.ttft_target_ms)
        self._reg.gauge("slo/tpot_target_ms").set(self.tpot_target_ms)

    def _publish(self) -> None:
        for metric in ("ttft", "tpot"):
            self._reg.gauge(f"slo/{metric}_requests").set(self._total[metric])
            att = self.attainment(metric)
            if att is not None:
                self._reg.gauge(f"slo/{metric}_attainment").set(att)
            for w in self.windows:
                burn = self.burn_rate(metric, w)
                if burn is not None:
                    self._reg.gauge(
                        f"slo/{metric}_burn_rate_{int(w)}s").set(burn)
            self._maybe_trigger_capture(metric)

    def _maybe_trigger_capture(self, metric: str) -> None:
        """Fast-window burn crossing -> profile trigger hub. Edge-detected:
        fires on the upward crossing only, and the hub's cooldown/dedupe
        bound how often evidence capture can actually arm."""
        if self.burn_threshold <= 0 or not self.windows:
            return
        fast = self.windows[0]
        with self._lock:
            cut = self._clock() - fast
            rows = [ok for (t, ok) in self._samples[metric] if t >= cut]
        if len(rows) < MIN_BURN_SAMPLES:
            return
        att = sum(rows) / len(rows)
        burn = (1.0 - att) / (1.0 - self.objective)
        above = burn >= self.burn_threshold
        fire = above and not self._burning[metric]
        self._burning[metric] = above
        if not fire:
            return
        from tfde_tpu_torch.observability import profiler

        profiler.trigger(
            f"slo_burn_{metric}",
            burn_rate=round(burn, 2),
            window_s=fast,
            threshold=self.burn_threshold,
        )
