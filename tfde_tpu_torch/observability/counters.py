"""Process-wide named counters — a thin shim over the metric registry
(observability/metrics.py), copied from
`tfde_tpu/observability/counters.py`: monotonic named counters, a
snapshot, a prefix reset and a TensorBoard bridge. Every call lands in
`metrics.default_registry()`, so a counter incremented here rides every
exposition path (the resilience sinks in resilience/health.py use it).
"""

from __future__ import annotations

from typing import Dict

from tfde_tpu_torch.observability import metrics


def incr(name: str, amount: float = 1.0) -> float:
    """Add `amount` to counter `name` (creating it at 0); returns the new
    value. Negative amounts are rejected — counters are monotonic; use a
    registry gauge for values that can fall."""
    return metrics.default_registry().counter(name).incr(amount)


def value(name: str) -> float:
    m = metrics.default_registry().get(name)
    return m.value if m is not None and m.kind == "counter" else 0.0


def snapshot() -> Dict[str, float]:
    """Point-in-time copy of every counter (counters only — gauges and
    histograms live in the registry's own snapshot())."""
    reg = metrics.default_registry()
    return {
        name: v for name, v in reg.scalars().items()
        if reg.get(name) is not None and reg.get(name).kind == "counter"
    }


def reset(prefix: str = "") -> None:
    """Drop counters (those under `prefix`, or all) — test isolation hook.
    Only counters: a prefix-less reset here must not clear the registry's
    gauges/histograms out from under their owners."""
    reg = metrics.default_registry()
    for name in list(snapshot()):
        if name.startswith(prefix):
            reg.remove(name)


def export_scalars(writer, step: int, prefix: str = "") -> Dict[str, float]:
    """Write the current snapshot (optionally filtered by `prefix`) to a
    SummaryWriter-compatible object at `step`; returns what was written.
    `writer` may be None (non-chief / no model_dir) — then this is only the
    snapshot read."""
    snap = {k: v for k, v in snapshot().items() if k.startswith(prefix)}
    if writer is not None and snap:
        writer.scalars(step, snap)
    return snap
