"""The port's cluster aggregation (tfde_tpu_torch/observability/
aggregate.py, exposition.py) and health sinks (resilience/health.py)
against the JAX package: twins of the twelve tests of
`tests/test_aggregate.py` — the push/rollup round trip over real HTTP,
straggler flagging from rolling step-time medians, dead-host staleness
in virtual time — plus the three health sinks.

The port has no `MetricsServer` yet, so the chief's HTTP endpoint in
these tests is the JAX package's, serving a PORT aggregator over a PORT
registry (the endpoint only calls `ingest`, `rollup`,
`prometheus_text`, `pending_profile` and `snapshot`): the port's pushes
and rollups cross the JAX wire. The JAX test of that endpoint's
port-in-use fallback has as its twin the exposition check: for the same
pushes and registry the port's `prometheus_text()` and
`to_prometheus_text()` equal the JAX text.

Everything runs on private registries and injected clocks and
callbacks, apart from the health sinks, which write the default
registries."""

import json
import time
import urllib.error
import urllib.request

import pytest

from tfde_tpu.observability import aggregate as jaggregate
from tfde_tpu.observability import exposition as jexposition
from tfde_tpu.observability import flightrec as jflightrec
from tfde_tpu.observability import metrics as jmetrics
from tfde_tpu.observability.exposition import MetricsServer, PROM_CONTENT_TYPE
from tfde_tpu.resilience import health as jhealth
from tfde_tpu_torch.observability import exposition, flightrec, metrics
from tfde_tpu_torch.observability.aggregate import (
    ClusterAggregator,
    MetricsPusher,
    collect_trace,
    fetch_trace,
    push_once,
    snapshot_payload,
)
from tfde_tpu_torch.resilience import health

#: the timeout of every HTTP call in this file, seconds
T = 30


def _payload(host, step_sum, step_count, ts=0.0, extra=None):
    m = {"train/step/sum": step_sum, "train/step/count": step_count}
    m.update(extra or {})
    return {"host": host, "pid": 1, "ts": ts, "metrics": m}


def _sinks():
    """Recorded on_straggler/on_stale callbacks."""
    calls = {"straggler": [], "stale": []}
    return (calls,
            lambda h, r: calls["straggler"].append((h, r)),
            lambda h, a: calls["stale"].append((h, a)))


def _chief(reg, agg):
    return MetricsServer(port=0, host="127.0.0.1", registry=reg,
                         aggregator=agg)


# -- push/rollup round-trip over real HTTP -----------------------------------
def test_push_rollup_roundtrip_over_http():
    chief_reg = metrics.Registry()
    chief_reg.gauge("train/steps_per_sec").set(10.0)
    calls, on_strag, on_stale = _sinks()
    agg = ClusterAggregator(registry=chief_reg, include_local=0,
                            on_straggler=on_strag, on_stale=on_stale)
    srv = _chief(chief_reg, agg)
    try:
        worker_reg = metrics.Registry()
        worker_reg.gauge("train/steps_per_sec").set(33.0)
        worker_reg.histogram("train/step").observe(0.1)
        url = f"http://127.0.0.1:{srv.port}"
        assert push_once(f"{url}/push", registry=worker_reg, host=1)
        resp = urllib.request.urlopen(f"{url}/metrics", timeout=T)
        assert resp.headers.get("Content-Type") == PROM_CONTENT_TYPE
        assert exposition.PROM_CONTENT_TYPE == PROM_CONTENT_TYPE
        body = resp.read().decode()
        assert "tfde_train_steps_per_sec 10.0" in body
        assert 'tfde_train_steps_per_sec{host="1"} 33.0' in body
        assert 'tfde_cluster_host_up{host="1"} 1' in body
        assert 'tfde_cluster_host_up{host="0"} 1' in body
        assert "tfde_cluster_hosts_reporting 2" in body
    finally:
        srv.close()


def test_push_rejects_garbage_and_missing_aggregator():
    reg = metrics.Registry()
    calls, on_strag, on_stale = _sinks()
    agg = ClusterAggregator(registry=reg, on_straggler=on_strag,
                            on_stale=on_stale)
    srv = _chief(reg, agg)
    bare = MetricsServer(port=0, host="127.0.0.1", registry=reg)
    try:
        def post(port, data):
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/push", data=data,
                headers={"Content-Type": "application/json"}, method="POST")
            try:
                return urllib.request.urlopen(req, timeout=T).status
            except urllib.error.HTTPError as e:
                return e.code

        assert post(srv.port, b"not json") == 400
        assert post(srv.port, json.dumps({"metrics": {}}).encode()) == 400
        assert post(bare.port, json.dumps(_payload(1, 1, 1)).encode()) == 404
        assert post(srv.port,
                    json.dumps(_payload(1, 1.0, 10.0)).encode()) == 200
        assert agg.hosts()[1]["pushes"] == 1
    finally:
        srv.close()
        bare.close()


def test_push_once_unreachable_returns_false_never_raises():
    reg = metrics.Registry()
    assert push_once("http://127.0.0.1:1/push", registry=reg, host=9,
                     timeout=0.2) is False
    assert fetch_trace("http://127.0.0.1:1", "t", timeout=0.2) == []
    out = collect_trace("t", ["http://127.0.0.1:1"],
                        local_events=[{"ts": 1.0, "name": "router/request",
                                       "proc": "router", "trace": "t"}],
                        timeout=0.2)
    assert out["procs"] == ["router"] and len(out["events"]) == 1


def test_snapshot_payload_shape():
    reg = metrics.Registry()
    reg.counter("c").incr(2)
    reg.histogram("h").observe(0.5)
    p = snapshot_payload(reg, host=3)
    assert p["host"] == 3 and p["pid"] > 0 and p["ts"] > 0
    assert p["metrics"]["c"] == 2.0
    jreg = jmetrics.Registry()
    jreg.counter("c").incr(2)
    jreg.histogram("h").observe(0.5)
    assert p["metrics"] == jaggregate.snapshot_payload(jreg, 3)["metrics"]


def test_metrics_pusher_thread_pushes_and_final_push():
    reg = metrics.Registry()
    calls, on_strag, on_stale = _sinks()
    agg = ClusterAggregator(registry=reg, on_straggler=on_strag,
                            on_stale=on_stale)
    srv = _chief(reg, agg)
    try:
        wreg = metrics.Registry()
        wreg.gauge("g").set(1.0)
        pusher = MetricsPusher(f"http://127.0.0.1:{srv.port}/push",
                               interval=0.05, registry=wreg, host=2)
        deadline = time.time() + 10.0
        while not agg.hosts().get(2) and time.time() < deadline:
            time.sleep(0.02)
        assert agg.hosts()[2]["pushes"] >= 1
        before = agg.hosts()[2]["pushes"]
        pusher.close()
        assert agg.hosts()[2]["pushes"] >= before + 1
    finally:
        srv.close()


# -- straggler detection ------------------------------------------------------
def test_straggler_flagged_and_transition_deduped():
    reg = metrics.Registry()
    calls, on_strag, on_stale = _sinks()
    agg = ClusterAggregator(registry=reg, straggler_factor=2.0,
                            on_straggler=on_strag, on_stale=on_stale)
    agg.ingest(_payload(0, 1.0, 10.0))
    agg.ingest(_payload(1, 1.0, 10.0))
    agg.ingest(_payload(2, 10.0, 10.0))
    out = agg.rollup()
    assert out["straggler_host"] == 2
    assert out["straggler_ratio"] == pytest.approx(10.0)
    assert out["host_medians_ms"][2] == pytest.approx(1000.0)
    assert reg.gauge("cluster/straggler_host").value == 2
    assert calls["straggler"] == [(2, pytest.approx(10.0))]
    agg.rollup()
    assert len(calls["straggler"]) == 1
    assert reg.gauge("cluster/step_time_median_ms").value == \
        pytest.approx(100.0)
    assert reg.gauge("cluster/step_time_max_ms").value == \
        pytest.approx(1000.0)


def test_straggler_needs_two_live_hosts():
    reg = metrics.Registry()
    calls, on_strag, on_stale = _sinks()
    agg = ClusterAggregator(registry=reg, on_straggler=on_strag,
                            on_stale=on_stale)
    agg.ingest(_payload(0, 50.0, 10.0))
    out = agg.rollup()
    assert out["straggler_host"] == -1
    assert calls["straggler"] == []


def test_medians_are_rolling_not_cumulative():
    reg = metrics.Registry()
    calls, on_strag, on_stale = _sinks()
    agg = ClusterAggregator(registry=reg, window=4,
                            on_straggler=on_strag, on_stale=on_stale)
    agg.ingest(_payload(0, 1.0, 10.0))
    s, c = 10.0, 10.0
    agg.ingest(_payload(1, s, c))
    for _ in range(5):
        s, c = s + 1.0, c + 10.0
        agg.ingest(_payload(1, s, c))
    out = agg.rollup()
    assert out["host_medians_ms"][1] == pytest.approx(100.0)
    assert out["straggler_host"] == -1


def test_straggler_factor_validated():
    with pytest.raises(ValueError):
        ClusterAggregator(registry=metrics.Registry(), straggler_factor=1.0)


# -- staleness ---------------------------------------------------------------
def test_dead_host_goes_stale_in_virtual_time():
    """The port aggregator and the JAX one, fed the same pushes on the
    same virtual clock, agree on every rollup and on the labelled
    Prometheus text."""
    now = [0.0]
    reg, jreg = metrics.Registry(), jmetrics.Registry()
    calls, on_strag, on_stale = _sinks()
    agg = ClusterAggregator(registry=reg, stale_after=5.0,
                            on_straggler=on_strag, on_stale=on_stale,
                            clock=lambda: now[0])
    jagg = jaggregate.ClusterAggregator(
        registry=jreg, stale_after=5.0, on_straggler=lambda h, r: None,
        on_stale=lambda h, a: None, clock=lambda: now[0])

    def ingest(p):
        agg.ingest(p)
        jagg.ingest(p)

    def rollup():
        out = agg.rollup()
        assert out == jagg.rollup()
        assert agg.prometheus_text() == jagg.prometheus_text()
        return out

    ingest(_payload(0, 1.0, 10.0))
    ingest(_payload(1, 1.0, 10.0))
    assert rollup()["hosts_stale"] == 0
    now[0] = 3.0
    ingest(_payload(0, 2.0, 20.0))
    now[0] = 6.0
    out = rollup()
    assert out["hosts_reporting"] == 1
    assert out["hosts_stale"] == 1 and out["stale_hosts"] == [1]
    assert 1 not in out["host_medians_ms"]
    assert calls["stale"] == [(1, pytest.approx(6.0))]
    rollup()
    assert len(calls["stale"]) == 1
    text = agg.prometheus_text()
    assert 'tfde_cluster_host_up{host="1"} 0' in text
    assert 'tfde_cluster_host_up{host="0"} 1' in text
    now[0] = 7.0
    ingest(_payload(1, 3.0, 25.0))
    out = rollup()
    assert out["hosts_stale"] == 0 and out["hosts_reporting"] == 2
    now[0] = 11.0
    ingest(_payload(0, 3.0, 30.0))
    now[0] = 13.0
    rollup()
    assert calls["stale"] == [(1, pytest.approx(6.0)),
                              (1, pytest.approx(6.0))]
    assert reg.scalars("cluster/") == jreg.scalars("cluster/")


def test_scrape_flips_staleness_without_new_pushes():
    now = [0.0]
    reg = metrics.Registry()
    calls, on_strag, on_stale = _sinks()
    agg = ClusterAggregator(registry=reg, stale_after=1.0,
                            on_straggler=on_strag, on_stale=on_stale,
                            clock=lambda: now[0])
    srv = _chief(reg, agg)
    try:
        url = f"http://127.0.0.1:{srv.port}/metrics"
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/push",
            data=json.dumps(_payload(1, 1.0, 10.0)).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        urllib.request.urlopen(req, timeout=T).read()
        body = urllib.request.urlopen(url, timeout=T).read().decode()
        assert "tfde_cluster_hosts_stale 0" in body
        now[0] = 2.0
        body = urllib.request.urlopen(url, timeout=T).read().decode()
        assert "tfde_cluster_hosts_stale 1" in body
        assert 'tfde_cluster_host_up{host="1"} 0' in body
    finally:
        srv.close()


# -- exposition ---------------------------------------------------------------
def test_prometheus_text_equals_jax_for_the_same_pushes():
    """`to_prometheus_text` of the same registry contents, its parse, and
    the aggregator's labelled text for the same pushes (histograms, KV
    and boot gauges included) equal the JAX package's."""
    reg, jreg = metrics.Registry(), jmetrics.Registry()
    for r in (reg, jreg):
        r.counter("serving/rejected_429").incr(3)
        r.gauge("kv/allocated_bytes").set(1024.0)
        r.histogram("serving/ttft_ms").observe(12.5)
        r.histogram("serving/ttft_ms").observe(800.0)
    text = exposition.to_prometheus_text(registry=reg)
    assert text == jexposition.to_prometheus_text(registry=jreg)
    assert exposition.parse_prometheus_text(text) == \
        jexposition.parse_prometheus_text(text)
    assert exposition.prom_name("kv/pad_waste_tokens/bucket_16") == \
        jexposition.prom_name("kv/pad_waste_tokens/bucket_16")
    now = [0.0]
    agg = ClusterAggregator(registry=metrics.Registry(), clock=lambda: now[0],
                            on_straggler=lambda h, r: None,
                            on_stale=lambda h, a: None)
    jagg = jaggregate.ClusterAggregator(
        registry=jmetrics.Registry(), clock=lambda: now[0],
        on_straggler=lambda h, r: None, on_stale=lambda h, a: None)
    for host, (r, jr) in enumerate(((reg, jreg), (reg, jreg))):
        p = snapshot_payload(r, host=host)
        jp = jaggregate.snapshot_payload(jr, host=host)
        assert p["metrics"] == jp["metrics"]
        agg.ingest(p)
        jagg.ingest(p)
        now[0] += 1.0
    agg.ingest(_payload(2, 1.0, 10.0, extra={
        "kv/allocated_bytes": 4096.0, "kv/waste_frac": 0.25,
        "kv/headroom_rows": 3.0, "boot/time_to_ready_seconds": 7.5}))
    jagg.ingest(_payload(2, 1.0, 10.0, extra={
        "kv/allocated_bytes": 4096.0, "kv/waste_frac": 0.25,
        "kv/headroom_rows": 3.0, "boot/time_to_ready_seconds": 7.5}))
    assert agg.prometheus_text() == jagg.prometheus_text()
    assert agg.rollup() == jagg.rollup()
    assert agg.host_metrics(("kv/", "boot/")) == \
        jagg.host_metrics(("kv/", "boot/"))


# -- health sinks -------------------------------------------------------------
def _sink_effects(pkg_metrics, pkg_flightrec, fn, *args, kind):
    reg = pkg_metrics.default_registry()
    reg.reset("resilience/")
    fn(*args)
    ev = [e for e in pkg_flightrec.default_recorder().events()
          if e["kind"] == kind][-1]
    ev = {k: v for k, v in ev.items() if k != "ts"}
    return reg.scalars("resilience/"), ev


@pytest.mark.parametrize("sink,args,kind", [
    ("note_straggler", (2, 3.5), "straggler"),
    ("note_replica_down", (1, "stream ended before done"), "replica_lost"),
    ("note_stale_host", (4, 16.25), "stale_host"),
])
def test_health_sink(sink, args, kind, monkeypatch):
    """Each sink moves the same counters and gauges and records the same
    flight event as the JAX sink (the JAX `note_stale_host`'s elastic
    suspicion is off without an elastic config, and the port has none)."""
    monkeypatch.delenv("TFDE_ELASTIC", raising=False)
    got = _sink_effects(metrics, flightrec, getattr(health, sink), *args,
                        kind=kind)
    want = _sink_effects(jmetrics, jflightrec, getattr(jhealth, sink), *args,
                         kind=kind)
    assert got == want
    assert got[0]
