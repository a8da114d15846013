"""Per-request distributed tracing for the serving path — a copy of
`tfde_tpu/observability/trace.py` (the same `HEADER`, event schema, dump
file, `stitch` and `to_chrome`, so a dump or a `/trace/<id>` slice of
either package stitches with the other's).

The metrics layer (metrics.py / aggregate.py) is aggregate by design:
histograms can say p99 TTFT regressed, never WHICH request, WHICH hop,
or WHY. This module adds the missing request-scoped timeline: the
Router mints a trace id per ``/v1/generate`` session and propagates it
via the ``X-Tfde-Trace`` HTTP header; every process on the request's
path (router, prefill-tier replica, decode replica) appends structured
span events to a bounded in-memory ring — queue, plan/admit (cold /
warm / primed, with prefix-cache hit + reused-token annotations),
per-scan-round decode, stream-out, and the primed-KV hand-off.

The ring has three exits:

- ``dump()`` writes ``<model_dir>/debug/trace_<host>_<pid>.jsonl``
  (armed like the flight recorder; ReplicaServer/Router dump on close);
- a replica serves its ring per trace id from ``GET /trace/<id>``, and
  the chief-side collector (`aggregate.collect_trace`) stitches the
  per-process rings into one cross-process waterfall;
- ``to_chrome()`` renders any event list as Chrome trace-event JSON
  (Perfetto/chrome://tracing loadable) — ``tools/obs_dump.py --trace``
  is the CLI for both.

Flag discipline (the `spans.set_trace_active` rule): tracing is OFF by
default and every hook begins with a single module-global check
(`active()`), so the steady-state serving cost of this file is one
pointer compare per call site. Enable with ``TFDE_TRACE=on`` (or an
integer ring capacity) in the environment — `tools/tier1.sh` forwards
it so the whole suite doubles as a tracing-on parity sweep — or
programmatically with `enable()`.

Exemplar linking: `note_exemplar(metric, value, trace_id)` keeps the
trace ids of the SLOWEST observations per metric (the batcher feeds
``serving/ttft_ms`` / ``serving/tpot_ms``), so "p99 got worse"
dereferences to concrete request waterfalls instead of a bucket count.
"""

from __future__ import annotations

import collections
import contextlib
import json
import logging
import os
import threading
import time
import uuid
from typing import Dict, Iterable, Iterator, List, Optional

from tfde_tpu_torch.observability.flightrec import _host_id

log = logging.getLogger(__name__)

DEFAULT_CAPACITY = 8192
#: the propagation header: router -> replicas on the request, router ->
#: client on the response
HEADER = "X-Tfde-Trace"
#: slowest observations kept per metric by the exemplar store
EXEMPLAR_KEEP = 8

#: event keys that are structural, not annotations (everything else is
#: carried into the Chrome export's `args`)
_CORE_KEYS = ("ts", "dur", "name", "proc", "pid", "trace", "traces")

_lock = threading.Lock()
#: the ring IS the on/off flag: None means off, and every record path
#: starts with that one read — the near-zero steady-state cost contract
_ring: Optional[collections.deque] = None
_proc: Optional[str] = None
_dump_dir: Optional[str] = None
_tls = threading.local()
_exemplars: Dict[str, List[tuple]] = {}


# -- lifecycle ---------------------------------------------------------------
def _env_capacity() -> Optional[int]:
    """``TFDE_TRACE`` -> ring capacity (None = off). Accepts on/off
    spellings or an integer capacity, the ``TFDE_PREFIX_CACHE`` idiom."""
    spec = os.environ.get("TFDE_TRACE", "off").strip().lower()
    if spec in ("", "0", "off", "false", "no", "none"):
        return None
    if spec in ("1", "on", "true", "yes"):
        return DEFAULT_CAPACITY
    try:
        return max(1, int(spec))
    except ValueError:
        log.warning("TFDE_TRACE=%r not understood; tracing on with the "
                    "default ring capacity", spec)
        return DEFAULT_CAPACITY


def enable(capacity: Optional[int] = None) -> None:
    """Turn recording on with a bounded ring (idempotent; re-enabling
    with a new capacity re-rings, keeping the newest events)."""
    global _ring
    cap = DEFAULT_CAPACITY if capacity is None else max(1, int(capacity))
    with _lock:
        old = list(_ring) if _ring is not None else []
        _ring = collections.deque(old, maxlen=cap)


def disable() -> None:
    """Turn recording off and drop everything (ring + exemplars) — back
    to the zero-cost state."""
    global _ring
    with _lock:
        _ring = None
        _exemplars.clear()


def active() -> bool:
    """THE hot-path guard every instrumentation site checks first."""
    return _ring is not None


def clear() -> None:
    with _lock:
        if _ring is not None:
            _ring.clear()
        _exemplars.clear()


# -- identity ----------------------------------------------------------------
def new_id() -> str:
    """Mint a trace id (the Router does this once per /v1/generate)."""
    return uuid.uuid4().hex[:16]


def set_process(label: str) -> None:
    """Name this process in every subsequent event ('router',
    'replica0', ...); defaults to 'host<process_index>'."""
    global _proc
    _proc = str(label)


def process() -> str:
    return _proc if _proc is not None else f"host{_host_id()}"


def current() -> Optional[str]:
    """The trace id bound to this thread (None outside `bind`)."""
    return getattr(_tls, "trace", None)


@contextlib.contextmanager
def bind(trace_id: Optional[str]) -> Iterator[None]:
    """Bind `trace_id` as this thread's current trace for the block, so
    `span()`/`event()` call sites that don't thread an id explicitly
    (e.g. spans.py's training-phase timers) still attach to it."""
    prev = getattr(_tls, "trace", None)
    _tls.trace = trace_id
    try:
        yield
    finally:
        _tls.trace = prev


# -- recording ---------------------------------------------------------------
def event(name: str, trace: Optional[str] = None,
          traces: Optional[Iterable[str]] = None,
          ts: Optional[float] = None, dur: Optional[float] = None,
          **args) -> None:
    """Append one span event. `trace` ties it to one request; `traces`
    to several (a decode scan serves many rows at once). `ts` is wall
    epoch seconds (defaults to now, minus `dur` when given — i.e. a
    duration recorded at block exit gets its START as the timestamp);
    `dur` is seconds. Extra kwargs are annotations. No-op unless
    `active()`."""
    ring = _ring
    if ring is None:
        return
    if ts is None:
        ts = time.time() - (dur or 0.0)
    ev: dict = {"ts": ts, "name": name, "proc": process(),
                "pid": os.getpid()}
    if trace is None and traces is None:
        trace = current()
    if trace is not None:
        ev["trace"] = trace
    if traces is not None:
        ev["traces"] = [t for t in traces if t is not None]
    if dur is not None:
        ev["dur"] = dur
    if args:
        ev.update(args)
    with _lock:
        ring.append(ev)


@contextlib.contextmanager
def span(name: str, trace: Optional[str] = None, **args) -> Iterator[None]:
    """Record the enclosed block as one duration event (recorded even
    when the block raises). Cheap no-op when tracing is off."""
    if _ring is None:
        yield
        return
    t0 = time.perf_counter()
    wall = time.time()
    try:
        yield
    finally:
        event(name, trace=trace, ts=wall,
              dur=time.perf_counter() - t0, **args)


def events(trace_id: Optional[str] = None) -> List[dict]:
    """Copy of the ring, oldest first; filtered to one trace id when
    given (an event matches via its `trace` field or membership in its
    `traces` list)."""
    with _lock:
        evs = list(_ring) if _ring is not None else []
    if trace_id is None:
        return evs
    return [e for e in evs
            if e.get("trace") == trace_id or trace_id in e.get("traces", ())]


# -- exemplars ---------------------------------------------------------------
def note_exemplar(metric: str, value: float,
                  trace_id: Optional[str]) -> None:
    """Remember `trace_id` as an exemplar for `metric` if `value` ranks
    among the slowest seen — the histogram-to-waterfall link."""
    if _ring is None or trace_id is None:
        return
    with _lock:
        lst = _exemplars.setdefault(metric, [])
        lst.append((float(value), trace_id))
        lst.sort(key=lambda p: -p[0])
        del lst[EXEMPLAR_KEEP:]


def exemplars(metric: Optional[str] = None):
    """Slowest-first [(value, trace id)] rows for one metric, or
    {metric: rows} for all of them."""
    with _lock:
        if metric is not None:
            return [{"value": v, "trace": t}
                    for v, t in _exemplars.get(metric, [])]
        return {m: [{"value": v, "trace": t} for v, t in lst]
                for m, lst in _exemplars.items()}


# -- dump / load (the flightrec file contract) -------------------------------
def arm(model_dir: str) -> None:
    """Fix the dump directory to ``<model_dir>/debug`` (no death hooks:
    the flight recorder owns those; a trace ring is dumped explicitly,
    typically at server close)."""
    global _dump_dir
    _dump_dir = os.path.join(model_dir, "debug")


def dump_path() -> Optional[str]:
    if _dump_dir is None:
        return None
    return os.path.join(_dump_dir,
                        f"trace_{_host_id()}_{os.getpid()}.jsonl")


def dump(reason: str = "manual") -> Optional[str]:
    """Atomically write the ring as JSONL (newest dump replaces the file
    whole). Returns the path; None when not armed or not active."""
    path = dump_path()
    if path is None or _ring is None:
        return None
    evs = events()
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            for ev in evs:
                f.write(json.dumps(ev, sort_keys=True, default=repr) + "\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except OSError:
        log.exception("trace dump to %s (%s) failed", path, reason)
        return None
    return path


def load(path: str) -> List[dict]:
    """Parse a dumped trace file back; tolerates a truncated tail."""
    out: List[dict] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                log.warning("trace file %s: skipping unparseable line",
                            path)
    return out


# -- stitching + Chrome export -----------------------------------------------
def stitch(event_lists: Iterable[List[dict]]) -> List[dict]:
    """Merge per-process event lists into one wall-clock timeline. All
    serving processes of one cluster share a machine (or NTP-close
    hosts), so epoch `ts` IS the common axis. Exact duplicates are
    dropped: when router and replica share a process (in-process tests,
    single-host dev), the collector sees the same ring twice — once
    locally, once over HTTP."""
    merged: List[dict] = []
    seen = set()
    for lst in event_lists:
        for e in lst:
            key = json.dumps(e, sort_keys=True, default=repr)
            if key in seen:
                continue
            seen.add(key)
            merged.append(e)
    merged.sort(key=lambda e: (e.get("ts", 0.0), e.get("name", "")))
    return merged


def to_chrome(evs: List[dict]) -> dict:
    """Render events as Chrome trace-event JSON: duration events become
    complete ('X') slices, instant events 'i' marks; each source process
    gets its own pid row named via 'process_name' metadata — load the
    result straight into Perfetto / chrome://tracing."""
    pids: Dict[str, int] = {}
    out: List[dict] = []
    for e in sorted(evs, key=lambda e: e.get("ts", 0.0)):
        proc = str(e.get("proc", "?"))
        pid = pids.setdefault(proc, len(pids) + 1)
        args = {k: v for k, v in e.items() if k not in _CORE_KEYS}
        if "trace" in e:
            args["trace"] = e["trace"]
        if "traces" in e:
            args["traces"] = e["traces"]
        rec = {
            "name": str(e.get("name", "?")),
            "cat": "serving",
            "ts": float(e.get("ts", 0.0)) * 1e6,   # epoch us
            "pid": pid,
            "tid": pid,
            "args": args,
        }
        if "dur" in e:
            rec["ph"] = "X"
            rec["dur"] = max(float(e["dur"]), 0.0) * 1e6
        else:
            rec["ph"] = "i"
            rec["s"] = "p"
        out.append(rec)
    meta = [{"name": "process_name", "ph": "M", "pid": pid, "tid": pid,
             "args": {"name": proc}} for proc, pid in pids.items()]
    return {"traceEvents": meta + out, "displayTimeUnit": "ms"}


# honor the env knob at import so subprocess replicas (which inherit the
# parent's environment) come up tracing without any wiring
_cap = _env_capacity()
if _cap is not None:
    enable(_cap)
del _cap
