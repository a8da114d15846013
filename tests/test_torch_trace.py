"""The port's request tracing, SLO tracker and span timers
(tfde_tpu_torch/observability/trace.py, slo.py, spans.py) against the
JAX package: twins of the fifteen tests of `tests/test_trace.py` (the
ring and its off contract, stitching, exemplars, the Chrome export,
burn-rate arithmetic, and the batcher's request waterfall — here the
port batcher's, held to the JAX batcher's event names on the same
weights), plus:

- a port dump loads with the JAX `trace.load` and stitches with JAX
  events through the JAX `stitch` to the events the port's own `stitch`
  gives, and the two `to_chrome` renderings agree;
- a span times its block into the registry, lands on the trace ring with
  the thread's bound trace id, and enters a `record_function` region
  only while a profiler window is open (on the CPU's torch profiler).
"""

import json
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfde_tpu.inference import server as jserver
from tfde_tpu.models.gpt import gpt_tiny_test as j_tiny
from tfde_tpu.observability import trace as jtrace
from tfde_tpu_torch.inference import server as tserver
from tfde_tpu_torch.models.flax_weights import from_flax_params
from tfde_tpu_torch.models.gpt import gpt_tiny_test
from tfde_tpu_torch.observability import metrics, spans
from tfde_tpu_torch.observability import trace
from tfde_tpu_torch.observability.slo import SLOTracker
from tfde_tpu_torch.testing import one_thread

#: one intra-op torch thread for the module (`testing.one_thread`)
_one_thread = pytest.fixture(autouse=True, scope="module")(one_thread)


@pytest.fixture(autouse=True)
def _trace_state():
    """Tracing is process-global in both packages: every test starts off
    and leaves off with clean rings."""
    was = trace.active(), jtrace.active()
    trace.disable()
    jtrace.disable()
    yield
    trace.disable()
    jtrace.disable()
    if was[0]:
        trace.enable()
    if was[1]:
        jtrace.enable()


# -- ring semantics + the off contract ----------------------------------------
def test_off_by_default_records_nothing():
    assert not trace.active()
    trace.event("serve/queued", trace="t1", depth=3)
    with trace.span("serve/prefill", trace="t1"):
        pass
    trace.note_exemplar("serving/ttft_ms", 12.0, "t1")
    assert trace.events() == []
    assert trace.exemplars() == {}
    assert trace.dump("off") is None


def test_ring_bounds_evict_oldest():
    trace.enable(capacity=4)
    for i in range(7):
        trace.event("e", trace="t", i=i)
    evs = trace.events()
    assert len(evs) == 4
    assert [e["i"] for e in evs] == [3, 4, 5, 6]


def test_reenable_rerings_keeping_newest():
    trace.enable(capacity=8)
    for i in range(6):
        trace.event("e", i=i)
    trace.enable(capacity=2)
    assert [e["i"] for e in trace.events()] == [4, 5]


def test_env_capacity_spellings(monkeypatch):
    for spec, want in [("off", None), ("0", None), ("", None),
                       ("on", trace.DEFAULT_CAPACITY),
                       ("1", trace.DEFAULT_CAPACITY),
                       ("4096", 4096)]:
        monkeypatch.setenv("TFDE_TRACE", spec)
        assert trace._env_capacity() == want == jtrace._env_capacity(), spec
    monkeypatch.setenv("TFDE_TRACE", "sideways")  # warn, fail on
    assert trace._env_capacity() == trace.DEFAULT_CAPACITY
    assert trace.DEFAULT_CAPACITY == jtrace.DEFAULT_CAPACITY
    assert trace.HEADER == jtrace.HEADER == "X-Tfde-Trace"


def test_event_filter_by_trace_and_traces():
    trace.enable()
    trace.event("a", trace="t1")
    trace.event("b", trace="t2")
    trace.event("wave", traces=["t1", "t2"], rows=2)
    assert [e["name"] for e in trace.events("t1")] == ["a", "wave"]
    assert [e["name"] for e in trace.events("t2")] == ["b", "wave"]
    assert len(trace.events()) == 3


def test_span_records_start_timestamp():
    trace.enable()
    before = time.time()
    with trace.span("slow", trace="t"):
        time.sleep(0.02)
    (ev,) = trace.events("t")
    assert ev["dur"] >= 0.02
    assert before <= ev["ts"] <= before + 0.01


def test_bind_attaches_thread_local_trace():
    trace.enable()
    with trace.bind("t9"):
        assert trace.current() == "t9"
        trace.event("implicit")
    assert trace.current() is None
    assert [e["name"] for e in trace.events("t9")] == ["implicit"]
    seen = {}
    with trace.bind("t9"):
        th = threading.Thread(
            target=lambda: seen.setdefault("cur", trace.current()))
        th.start()
        th.join()
    assert seen["cur"] is None


# -- exemplars ----------------------------------------------------------------
def test_exemplars_keep_slowest():
    trace.enable()
    for i in range(12):
        trace.note_exemplar("serving/ttft_ms", float(i), f"id{i}")
    rows = trace.exemplars("serving/ttft_ms")
    assert len(rows) == trace.EXEMPLAR_KEEP == jtrace.EXEMPLAR_KEEP
    assert [r["value"] for r in rows] == [11.0, 10.0, 9.0, 8.0,
                                          7.0, 6.0, 5.0, 4.0]
    assert rows[0]["trace"] == "id11"
    assert "serving/ttft_ms" in trace.exemplars()


# -- dump / load / stitch -----------------------------------------------------
def test_dump_load_roundtrip(tmp_path):
    """A port dump loads with both packages' `load` (truncated tail
    tolerated), and its file name is the JAX one."""
    trace.enable()
    trace.arm(str(tmp_path))
    trace.event("serve/queued", trace="t1", depth=1)
    trace.event("serve/done", trace="t1", tokens=4)
    path = trace.dump("test")
    assert path is not None and path.endswith(".jsonl")
    assert path.split("/")[-1].startswith("trace_")
    with open(path, "a") as f:
        f.write("{truncated crash li")
    for load in (trace.load, jtrace.load):
        evs = load(path)
        assert [e["name"] for e in evs] == ["serve/queued", "serve/done"]
        assert evs[1]["tokens"] == 4


def test_stitch_dedupes_and_orders_across_procs():
    router = [{"ts": 2.0, "name": "router/done", "proc": "router"},
              {"ts": 0.0, "name": "router/request", "proc": "router"}]
    replica = [{"ts": 1.0, "name": "serve/queued", "proc": "replica0"},
               {"ts": 0.0, "name": "router/request", "proc": "router"}]
    out = trace.stitch([router, replica])
    assert [e["name"] for e in out] == [
        "router/request", "serve/queued", "router/done"]
    assert out == jtrace.stitch([router, replica])


def test_port_dump_stitches_with_jax_events(tmp_path):
    """A port replica's dumped ring and a JAX router's ring stitch, with
    either package's `stitch`, into one timeline; the Chrome exports
    agree."""
    trace.enable()
    jtrace.enable()
    trace.arm(str(tmp_path / "port"))
    trace.set_process("replica0")
    jtrace.set_process("router")
    try:
        jtrace.event("router/request", trace="t1", prompt_tokens=4)
        trace.event("serve/queued", trace="t1", rid=0)
        with trace.span("serve/prefill_cold", trace="t1", rows=1):
            time.sleep(0.002)
        jtrace.event("router/done", trace="t1", dur=0.01)
        path = trace.dump("replica_close")
        port_evs = jtrace.load(path)
        jax_evs = jtrace.events("t1")
        want = trace.stitch([port_evs, jax_evs, port_evs])
        assert jtrace.stitch([port_evs, jax_evs, port_evs]) == want
        assert len(want) == 4
        assert {e["proc"] for e in want} == {"router", "replica0"}
        assert trace.to_chrome(want) == jtrace.to_chrome(want)
    finally:
        trace._proc = None
        jtrace._proc = None


# -- Chrome trace-event export ------------------------------------------------
def test_to_chrome_schema():
    evs = [
        {"ts": 10.0, "dur": 0.5, "name": "serve/prefill_cold",
         "proc": "replica0", "pid": 123, "trace": "t1", "rows": 2},
        {"ts": 10.2, "name": "serve/first_token", "proc": "replica0",
         "pid": 123, "trace": "t1"},
        {"ts": 9.9, "name": "router/request", "proc": "router",
         "pid": 7, "trace": "t1"},
    ]
    doc = trace.to_chrome(evs)
    assert doc == jtrace.to_chrome(evs)
    assert set(doc) == {"traceEvents", "displayTimeUnit"}
    body = json.loads(json.dumps(doc))
    metas = [e for e in body["traceEvents"] if e["ph"] == "M"]
    assert {m["args"]["name"] for m in metas} == {"router", "replica0"}
    (sl,) = [e for e in body["traceEvents"] if e["ph"] == "X"]
    assert sl["dur"] == pytest.approx(0.5e6)
    assert sl["ts"] == pytest.approx(10.0 * 1e6)
    assert sl["args"]["rows"] == 2 and sl["args"]["trace"] == "t1"
    instants = [e for e in body["traceEvents"] if e["ph"] == "i"]
    assert len(instants) == 2 and all(e["s"] == "p" for e in instants)
    assert sl["pid"] == next(m["pid"] for m in metas
                             if m["args"]["name"] == "replica0")


# -- SLO tracker --------------------------------------------------------------
def test_slo_attainment_and_burn_rate_arithmetic():
    t = {"now": 1000.0}
    reg = metrics.Registry()
    s = SLOTracker(ttft_target_ms=100.0, tpot_target_ms=50.0,
                   objective=0.99, windows=(60.0,), registry=reg,
                   clock=lambda: t["now"])
    assert s.attainment("ttft") is None
    assert s.burn_rate("ttft", 60.0) is None
    s.record(ttft_ms=80.0, tpot_ms=40.0)
    s.record(ttft_ms=150.0)
    assert s.attainment("ttft") == pytest.approx(0.5)
    assert s.attainment("tpot") == pytest.approx(1.0)
    assert s.burn_rate("ttft", 60.0) == pytest.approx(50.0)
    assert s.burn_rate("tpot", 60.0) == pytest.approx(0.0)
    t["now"] += 120.0
    s.record(ttft_ms=10.0)
    assert s.attainment("ttft", window=60.0) == pytest.approx(1.0)
    assert s.attainment("ttft") == pytest.approx(2.0 / 3.0)
    assert s.burn_rate("ttft", 60.0) == pytest.approx(0.0)


def test_slo_summary_and_gauges():
    """The summary and the gauges equal the JAX tracker's on the same
    records."""
    from tfde_tpu.observability import metrics as jmetrics
    from tfde_tpu.observability.slo import SLOTracker as JSLOTracker

    reg = metrics.Registry()
    s = SLOTracker(ttft_target_ms=100.0, tpot_target_ms=50.0,
                   objective=0.9, windows=(300.0, 3600.0), registry=reg)
    jreg = jmetrics.Registry()
    js = JSLOTracker(ttft_target_ms=100.0, tpot_target_ms=50.0,
                     objective=0.9, windows=(300.0, 3600.0), registry=jreg)
    for tracker in (s, js):
        tracker.record(ttft_ms=500.0, tpot_ms=10.0)
    out = s.summary()
    assert out == js.summary()
    assert out["objective"] == pytest.approx(0.9)
    assert out["ttft_requests"] == 1 and out["tpot_requests"] == 1
    assert out["ttft_attainment"] == pytest.approx(0.0)
    assert out["ttft_burn_rate"]["300s"] == pytest.approx(10.0)
    assert out["windows_s"] == [300.0, 3600.0]
    json.dumps(out)
    snap = reg.snapshot()
    assert snap == jreg.snapshot()
    assert snap["slo/ttft_attainment"]["value"] == pytest.approx(0.0)
    assert snap["slo/ttft_burn_rate_300s"]["value"] == pytest.approx(10.0)
    assert snap["slo/objective"]["value"] == pytest.approx(0.9)


def test_slo_objective_clamped_off_the_pole():
    s = SLOTracker(objective=1.0, registry=metrics.Registry())
    assert s.objective <= 0.9999
    s.record(ttft_ms=1e9)
    assert s.burn_rate("ttft", s.windows[0]) is not None


# -- the serving path annotates -----------------------------------------------
def test_batcher_emits_request_waterfall():
    """A port ContinuousBatcher run with one traced request beside an
    untraced one: the ring tells the request's whole story, with the JAX
    batcher's event names on the same weights and prompts (its
    recompile sentinel's compile/* events aside), and feeds the TTFT
    exemplar store."""
    jm = j_tiny()
    params = jm.init(jax.random.key(1), jnp.zeros((1, 8), jnp.int32))["params"]
    tm = gpt_tiny_test(device="cpu")
    tm.load_state_dict(from_flax_params(jax.tree.map(np.asarray, params)))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 97, 4), rng.integers(0, 97, 3)]
    names = []
    for pkg, srv in ((jtrace, jserver.ContinuousBatcher(
            jm, params, batch_size=2, max_len=48)),
                     (trace, tserver.ContinuousBatcher(
                         tm, batch_size=2, max_len=48, device="cpu"))):
        pkg.enable()
        tid = pkg.new_id()
        srv.submit(prompts[0], 6, trace=tid)
        srv.submit(prompts[1], 4)
        done = srv.run()
        assert len(done) == 2
        names.append([e["name"] for e in pkg.events(tid)
                      if not e["name"].startswith("compile/")])
        for e in pkg.events():
            assert e.get("trace") in (None, tid)
            assert set(e.get("traces", ())) <= {tid}
        assert [r["trace"] for r in pkg.exemplars("serving/ttft_ms")] == [tid]
        assert [r["trace"] for r in pkg.exemplars("serving/tpot_ms")] == [tid]
    got = names[1]
    assert got == names[0]
    assert got[0] == "serve/queued"
    assert any(n.startswith("serve/prefill_") for n in got)
    assert "serve/first_token" in got and "serve/decode_round" in got
    assert got.index("serve/done") > got.index("serve/first_token")


# -- spans ----------------------------------------------------------------------
def test_span_times_into_registry_and_ring():
    """A span observes its host seconds into `histogram(name)` (even when
    the block raises) and, with the ring on, lands as a duration event
    carrying the thread's bound trace id."""
    reg = metrics.Registry()
    with spans.span("serving/decode", registry=reg):
        time.sleep(0.01)
    with pytest.raises(ValueError):
        with spans.span("serving/decode", registry=reg):
            raise ValueError("boom")
    h = reg.histogram("serving/decode")
    assert h.count == 2 and h.sum >= 0.01
    spans.record("serving/decode", 0.5, registry=reg)
    assert h.count == 3
    assert trace.events() == []        # ring off: nothing recorded
    trace.enable()
    with trace.bind("t7"):
        with spans.span("serving/prefill", registry=reg):
            pass
    (ev,) = trace.events("t7")
    assert ev["name"] == "serving/prefill" and ev["dur"] >= 0.0


def test_span_enters_record_function_only_in_a_profiler_window():
    """While profiler.py's window is open (`set_trace_active`) a span is a
    `record_function` region of its name on the torch profiler's
    timeline; outside a window it builds none."""
    reg = metrics.Registry()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with spans.span("serving/outside", registry=reg):
            torch.ones(4).sum()
        spans.set_trace_active(True)
        try:
            with spans.span("serving/inside", registry=reg):
                torch.ones(4).sum()
        finally:
            spans.set_trace_active(False)
    names = {e.key for e in prof.key_averages()}
    assert "serving/inside" in names
    assert "serving/outside" not in names
    assert not spans.trace_active()
