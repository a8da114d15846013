"""Lightweight span timers feeding the metric registry — the port of
`tfde_tpu/observability/spans.py`.

    with span("serving/decode"):
        out = run_round(...)

Each span observes its wall duration into `registry.histogram(name)`.
The duration is what the HOST spent in the block: a span adds no
`torch.cuda.synchronize`, so a block that only launches CUDA work
measures the launches, as a JAX span measures the dispatch under
asynchronous execution. A block that ends in a device-to-host copy (the
batcher's prefill waves and decode rounds each end in one) measures the
device work too.

While a torch profiler window is open (observability/profiler.py flips
`set_trace_active`), every span additionally enters
`torch.profiler.record_function(name)`, so the SAME names appear on the
profiler's timeline — where JAX opens a `jax.profiler.TraceAnnotation`.
The region is only built while tracing, keeping the steady-state span
cost to a clock read and a locked histogram add.

When the request-trace ring (trace.py) is active, every span ALSO lands
as a duration event on that timeline, tagged with the thread's bound
trace id (`trace.bind`).
"""

from __future__ import annotations

import contextlib
import time
from typing import Iterator, Optional

from tfde_tpu_torch.observability import metrics
from tfde_tpu_torch.observability import trace as reqtrace

_trace_active = False


def set_trace_active(active: bool) -> None:
    """Flipped by profiler.py when a torch profiler window opens or
    closes; spans enter `record_function` regions only while True."""
    global _trace_active
    _trace_active = bool(active)


def trace_active() -> bool:
    return _trace_active


@contextlib.contextmanager
def span(name: str,
         registry: Optional[metrics.Registry] = None) -> Iterator[None]:
    """Time the enclosed block into `histogram(name)` (seconds of host
    time); mirror it as a `record_function` region while a profiler
    window is open. Duration is recorded even when the block raises — a
    failing phase still spent the wall-clock."""
    reg = registry or metrics.default_registry()
    region = None
    if _trace_active:
        import torch

        region = torch.profiler.record_function(name)
        region.__enter__()
    wall = time.time() if reqtrace.active() else None
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        if region is not None:
            region.__exit__(None, None, None)
        reg.histogram(name).observe(dt)
        if wall is not None:
            # same name, same timeline: picks up the thread's bound
            # request id (trace.bind) automatically via current()
            reqtrace.event(name, ts=wall, dur=dt)


def record(name: str, seconds: float,
           registry: Optional[metrics.Registry] = None) -> None:
    """Observe an externally measured duration under a span name — for
    call sites that already hold a timer and can't wrap a `with` block
    around the wait."""
    (registry or metrics.default_registry()).histogram(name).observe(seconds)
