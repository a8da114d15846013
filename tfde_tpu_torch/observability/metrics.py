"""Process-wide metric registry: counters, gauges, and fixed-bucket
histograms — a host-only copy of `tfde_tpu/observability/metrics.py`
(pure Python; the port never imports the JAX package).

The port's serving capacity ledger and usage meter
(observability/capacity.py) publish their ``kv/*`` gauges and
``usage/*`` counters here, under the JAX package's names.

Design points:
- Thread-safe: one registry-wide RLock; metric mutations are a few adds
  under it, so a step loop can write while another thread reads.
- Histograms are FIXED-BUCKET (Prometheus classic style): observation cost
  is O(log buckets), memory is O(buckets), and percentiles come from linear
  interpolation within the covering bucket — accurate to a bucket width,
  which the default exponential seconds-ladder keeps proportional to the
  value. Min/max are tracked exactly and clamp the interpolation.
- `snapshot()` / `reset()` are the test hooks: a snapshot is plain data
  (floats and dicts), safe to serialize or diff.
"""

from __future__ import annotations

import bisect
import threading
from typing import Dict, Optional, Sequence, Tuple, Union

#: Default histogram buckets: an exponential seconds ladder from 0.5 ms to
#: 5 minutes — wide enough for a data-wait microsecond and a checkpoint
#: restore alike. Upper bounds are inclusive (`le`, Prometheus semantics);
#: values beyond the last bound land in the implicit +Inf bucket.
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0,
)


class Counter:
    """Monotonic named counter. Negative increments are rejected — rates
    and totals must only grow; a value that can fall is a Gauge."""

    kind = "counter"

    def __init__(self, name: str, lock: threading.RLock):
        self.name = name
        self._lock = lock
        self._value = 0.0

    def incr(self, amount: float = 1.0) -> float:
        if amount < 0:
            raise ValueError(f"counter {self.name!r}: negative increment {amount}")
        with self._lock:
            self._value += amount
            return self._value

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def _reset(self) -> None:
        self._value = 0.0

    def _snapshot(self) -> float:
        return self._value


class Gauge:
    """Last-written value (queue depth, goodput fraction, steps/sec)."""

    kind = "gauge"

    def __init__(self, name: str, lock: threading.RLock):
        self.name = name
        self._lock = lock
        self._value = 0.0

    def set(self, value: float) -> float:
        with self._lock:
            self._value = float(value)
            return self._value

    def add(self, amount: float) -> float:
        with self._lock:
            self._value += amount
            return self._value

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def _reset(self) -> None:
        self._value = 0.0

    def _snapshot(self) -> float:
        return self._value


class Histogram:
    """Fixed-bucket histogram with interpolated percentile readout.

    `bounds` are inclusive upper edges (sorted, finite); an implicit +Inf
    bucket catches the overflow. `percentile(q)` walks the cumulative
    counts to the covering bucket and interpolates linearly inside it,
    clamped to the exact observed min/max — so p50/p95/p99 are correct to
    a bucket width even though individual observations are not retained.
    """

    kind = "histogram"

    def __init__(self, name: str, lock: threading.RLock,
                 buckets: Optional[Sequence[float]] = None):
        bounds = tuple(sorted(float(b) for b in (buckets or DEFAULT_BUCKETS)))
        if not bounds or len(set(bounds)) != len(bounds):
            raise ValueError(f"histogram {name!r}: buckets must be distinct")
        self.name = name
        self.bounds = bounds
        self._lock = lock
        self._counts = [0] * (len(bounds) + 1)  # last slot = +Inf bucket
        self._sum = 0.0
        self._count = 0
        self._min = float("inf")
        self._max = float("-inf")

    def observe(self, value: float) -> None:
        value = float(value)
        i = bisect.bisect_left(self.bounds, value)
        with self._lock:
            self._counts[i] += 1
            self._sum += value
            self._count += 1
            if value < self._min:
                self._min = value
            if value > self._max:
                self._max = value

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    @property
    def mean(self) -> float:
        with self._lock:
            return self._sum / self._count if self._count else 0.0

    def percentile(self, q: float) -> float:
        """q in [0, 100]. 0.0 when nothing was observed."""
        if not 0 <= q <= 100:
            raise ValueError(f"percentile q must be in [0, 100], got {q}")
        with self._lock:
            return self._percentile_locked(q)

    def _percentile_locked(self, q: float) -> float:
        if self._count == 0:
            return 0.0
        rank = q / 100.0 * self._count  # fractional rank in (0, count]
        cum = 0
        for i, c in enumerate(self._counts):
            if c == 0:
                continue
            lo = self.bounds[i - 1] if i > 0 else self._min
            hi = self.bounds[i] if i < len(self.bounds) else self._max
            if cum + c >= rank:
                frac = (rank - cum) / c
                v = lo + frac * (hi - lo)
                return min(max(v, self._min), self._max)
            cum += c
        return self._max

    def _reset(self) -> None:
        self._counts = [0] * (len(self.bounds) + 1)
        self._sum = 0.0
        self._count = 0
        self._min = float("inf")
        self._max = float("-inf")

    def _snapshot(self) -> dict:
        cum, buckets = 0, []
        for i, b in enumerate(self.bounds):
            cum += self._counts[i]
            buckets.append((b, cum))
        return {
            "count": self._count,
            "sum": self._sum,
            "min": self._min if self._count else 0.0,
            "max": self._max if self._count else 0.0,
            "buckets": buckets,  # (inclusive upper bound, cumulative count)
            "p50": self._percentile_locked(50.0),
            "p95": self._percentile_locked(95.0),
            "p99": self._percentile_locked(99.0),
        }


Metric = Union[Counter, Gauge, Histogram]


class Registry:
    """Named-metric store. `counter()`/`gauge()`/`histogram()` get-or-create
    (a name is permanently one kind — a mismatch raises); `snapshot()` and
    `reset()` are the exporter/test surface."""

    def __init__(self):
        self._lock = threading.RLock()
        self._metrics: Dict[str, Metric] = {}
        self._collectors: list = []

    def add_collector(self, fn) -> None:
        """Register a callable run at the top of every `snapshot()` —
        the "metrics cadence" hook for values that must be *sampled*
        rather than pushed (live device-buffer totals). The
        collector runs OUTSIDE the registry lock (it is expected to set
        gauges on this registry) and its exceptions are swallowed: a
        broken sampler must not take the scrape path down."""
        with self._lock:
            if fn not in self._collectors:
                self._collectors.append(fn)

    def remove_collector(self, fn) -> None:
        with self._lock:
            if fn in self._collectors:
                self._collectors.remove(fn)

    def _get_or_create(self, name: str, cls, **kwargs) -> Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, self._lock, **kwargs)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise ValueError(
                    f"metric {name!r} is a {m.kind}, not a {cls.kind}"
                )
            return m

    def counter(self, name: str) -> Counter:
        return self._get_or_create(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get_or_create(name, Gauge)

    def histogram(self, name: str,
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        return self._get_or_create(name, Histogram, buckets=buckets)

    def get(self, name: str) -> Optional[Metric]:
        with self._lock:
            return self._metrics.get(name)

    def snapshot(self) -> Dict[str, dict]:
        """Point-in-time copy: {name: {"type": kind, **data}} where data is
        {"value": float} for counters/gauges and the histogram dict (count/
        sum/min/max/buckets/p50/p95/p99) for histograms. Plain data — safe
        to serialize, diff, or hand to exposition renderers."""
        with self._lock:
            collectors = list(self._collectors)
        for fn in collectors:  # outside the lock: collectors set gauges
            try:
                fn()
            except Exception:  # noqa: BLE001 — scrape must survive
                pass
        with self._lock:
            out = {}
            for name in sorted(self._metrics):
                m = self._metrics[name]
                data = m._snapshot()
                if m.kind == "histogram":
                    out[name] = {"type": m.kind, **data}
                else:
                    out[name] = {"type": m.kind, "value": data}
            return out

    def scalars(self, prefix: str = "") -> Dict[str, float]:
        """Counters and gauges only, as {name: value}, optionally
        filtered by prefix."""
        with self._lock:
            return {
                name: m._snapshot()
                for name, m in self._metrics.items()
                if m.kind != "histogram" and name.startswith(prefix)
            }

    def reset(self, prefix: str = "") -> None:
        """Drop metrics under `prefix` (or all) — test isolation hook.
        Dropping (not zeroing) keeps live references valid: a holder of a
        removed metric keeps a working but unregistered object."""
        with self._lock:
            for name in [n for n in self._metrics if n.startswith(prefix)]:
                del self._metrics[name]

    def remove(self, name: str) -> None:
        """Drop exactly `name` (no-op when absent) — unlike reset(), never
        touches other metrics that merely share the prefix."""
        with self._lock:
            self._metrics.pop(name, None)


_default = Registry()


def default_registry() -> Registry:
    """The process-wide registry every subsystem shares by default."""
    return _default


def counter(name: str) -> Counter:
    return _default.counter(name)


def gauge(name: str) -> Gauge:
    return _default.gauge(name)


def histogram(name: str, buckets: Optional[Sequence[float]] = None) -> Histogram:
    return _default.histogram(name, buckets=buckets)


def flatten_snapshot(snap: Dict[str, dict]) -> Dict[str, float]:
    """Flatten a `Registry.snapshot()` to {name: float} for scalar sinks
    (TensorBoard, JSONL): counters/gauges pass through, histograms expand
    to name/count, name/sum, name/mean, name/p50, name/p95, name/p99."""
    out: Dict[str, float] = {}
    for name, data in snap.items():
        if data["type"] == "histogram":
            count = data["count"]
            out[f"{name}/count"] = float(count)
            out[f"{name}/sum"] = float(data["sum"])
            out[f"{name}/mean"] = float(data["sum"] / count) if count else 0.0
            for p in ("p50", "p95", "p99"):
                out[f"{name}/{p}"] = float(data[p])
        else:
            out[name] = float(data["value"])
    return out
