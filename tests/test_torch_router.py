"""The port's serving front door (tfde_tpu_torch/inference/router.py:
`ReplicaServer`, `Router`, `request_generate`) against the JAX package
(`tests/test_router.py`, whose seventeen behaviours each have a twin
here, on port replicas over `gpt_tiny_test`'s weights shared with the
JAX model by `from_flax_params`): SSE round trips equal the JAX solo
`generate` token for token, placement follows the fewest outstanding
tokens, a dead replica is marked down and its traffic re-routed, /drain
stops new placement, the prefill tier primes remotely, aggregator push
staleness is a down signal, overload answers 429 with an integer
Retry-After, priorities round-trip and brownout sheds by priority,
readiness gates placement, and a deadline shed surfaces in-band.

Three cross-package tests hold the wire: a port Router in front of a JAX
ReplicaServer, a JAX Router in front of a port ReplicaServer, and a JAX
prefill replica handing its K/V to a port decode replica through the
port Router — each run's tokens equal the JAX solo run.

Every replica's step loop must still run when its test ends. Every HTTP
call carries its own timeout.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tfde_tpu.inference import router as jrouter
from tfde_tpu.inference import server as jserver
from tfde_tpu.inference.decode import generate as jgenerate
from tfde_tpu.models.gpt import gpt_tiny_test as j_tiny
from tfde_tpu_torch.inference import admission as tadmission
from tfde_tpu_torch.inference import server as tserver
from tfde_tpu_torch.inference.router import (
    ReplicaServer,
    Router,
    request_generate,
)
from tfde_tpu_torch.models.flax_weights import from_flax_params
from tfde_tpu_torch.models.gpt import gpt_tiny_test
from tfde_tpu_torch.observability import boot as tboot
from tfde_tpu_torch.observability import metrics
from tfde_tpu_torch.observability.aggregate import ClusterAggregator
from tfde_tpu_torch.observability.slo import SLOTracker
from tfde_tpu_torch.testing import one_thread

#: one intra-op torch thread for the module (`testing.one_thread`)
_one_thread = pytest.fixture(autouse=True, scope="module")(one_thread)

#: the timeout of every HTTP call in this file, seconds
T = 60


@pytest.fixture(scope="module")
def lm():
    jm = j_tiny()
    params = jm.init(jax.random.key(1), jnp.zeros((1, 8), jnp.int32))["params"]
    tm = gpt_tiny_test(device="cpu")
    tm.load_state_dict(from_flax_params(jax.tree.map(np.asarray, params)))
    return jm, params, tm


_SOLO: dict = {}


def _solo(lm, prompt, n):
    """The JAX package's greedy `generate` of `prompt`: its new tokens."""
    key = (tuple(int(t) for t in prompt), int(n))
    if key not in _SOLO:
        jm, params, _ = lm
        p = np.asarray(prompt, np.int64)
        toks, lengths = jgenerate(jm, params,
                                  jnp.asarray(p[None, :], jnp.int32),
                                  max_new_tokens=n)
        _SOLO[key] = np.asarray(toks)[0, p.size:int(lengths[0])].tolist()
    return _SOLO[key]


def _batcher(lm, role="both", batch=2, **kw):
    return tserver.ContinuousBatcher(lm[2], kv_quant="fp", batch_size=batch,
                                     max_len=64, role=role, device="cpu",
                                     **kw)


def _mk_replica(lm, idx, role="both", batch=2):
    return ReplicaServer(_batcher(lm, role, batch), replica_id=idx).start()


def _close(*servers):
    """Close each server, after holding that every replica's step loop
    still runs (an exception in `step()` ends it silently)."""
    for s in servers:
        if isinstance(s, ReplicaServer):
            assert s.loop_alive, f"replica {s.replica_id}'s step loop died"
    for s in servers:
        try:
            s.close()
        except OSError:
            pass  # a drill may have shut its front door already


def _post(url, payload, headers=None):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=T) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


@pytest.fixture()
def pair(lm):
    """Two live replicas and a router over them, torn down per test."""
    r0, r1 = _mk_replica(lm, 0), _mk_replica(lm, 1)
    router = Router([r0.url, r1.url]).start()
    yield r0, r1, router
    _close(router, r0, r1)


def test_sse_round_trip_matches_solo(lm, pair, rng):
    _r0, _r1, router = pair
    p = rng.integers(1, 90, 6).tolist()
    out = request_generate(router.url, p, 8, timeout=T)
    assert out["tokens"] == _solo(lm, p, 8)
    assert out["replica"] in (0, 1)
    assert out["ttft_s"] is not None and out["ttft_s"] > 0
    # the meta event, at least one token and the done event
    assert out["events"] >= 3
    assert out["trace"] is not None


def test_least_outstanding_tokens_placement(lm, pair, rng):
    """Holding replica 0's step lock stalls its decode while it still
    accepts the submit: the second concurrent request goes to replica
    1."""
    r0, _r1, router = pair
    long_p = rng.integers(1, 90, 4).tolist()
    short_p = rng.integers(1, 90, 6).tolist()
    res = {}
    with r0.lock:
        t = threading.Thread(target=lambda: res.update(
            a=request_generate(router.url, long_p, 40, timeout=T)))
        t.start()
        deadline = time.monotonic() + 10
        while (not any(r.outstanding for r in router._reps)
               and time.monotonic() < deadline):
            time.sleep(0.01)
        assert any(r.outstanding for r in router._reps)
        out2 = request_generate(router.url, short_p, 6, timeout=T)
    t.join(timeout=T)
    assert res["a"]["replica"] == 0 and out2["replica"] == 1
    assert res["a"]["tokens"] == _solo(lm, long_p, 40)
    assert out2["tokens"] == _solo(lm, short_p, 6)


def test_dead_replica_reroutes_and_marks_down(lm, pair, rng):
    r0, _r1, router = pair
    reg = metrics.default_registry()
    reg.reset("router/")
    r0._httpd.shutdown()
    r0._httpd.server_close()
    prompts = [rng.integers(1, 90, 5).tolist() for _ in range(3)]
    outs = [request_generate(router.url, p, 6, timeout=T) for p in prompts]
    assert all(o["replica"] == 1 for o in outs)
    for p, o in zip(prompts, outs):
        assert o["tokens"] == _solo(lm, p, 6)
    tab = {row["replica"]: row for row in router.table()}
    assert tab[0]["up"] is False and tab[1]["up"] is True
    assert reg.get("router/replicas_lost").value >= 1
    assert reg.get("router/replica0/up").value == 0
    assert reg.get("router/requests").value == 3


def test_drain_stops_new_placement(lm, pair, rng):
    _r0, _r1, router = pair
    code, body = _post(router.url + "/drain", {"replica": 0})
    assert code == 200 and body == {"drained": 0, "tier": "decode"}
    prompts = [rng.integers(1, 90, 5).tolist() for _ in range(3)]
    outs = [request_generate(router.url, p, 6, timeout=T) for p in prompts]
    assert all(o["replica"] == 1 for o in outs)
    assert outs[0]["tokens"] == _solo(lm, prompts[0], 6)
    tab = {row["replica"]: row for row in router.table()}
    assert tab[0]["drained"] is True and tab[0]["up"] is True


def test_drain_validation(pair):
    """/drain: 400 on a missing or garbage index or tier, 404 on an
    unknown index."""
    _r0, _r1, router = pair
    url = router.url + "/drain"
    assert _post(url, {})[0] == 400
    assert _post(url, {"replica": "zero"})[0] == 400
    assert _post(url, {"replica": 0, "tier": "bogus"})[0] == 400
    assert _post(url, {"replica": 7})[0] == 404
    assert _post(url, {"replica": 7, "tier": "prefill"})[0] == 404
    assert _post(url, {"replica": 1})[0] == 200
    tab = {row["replica"]: row for row in router.table()}
    assert tab[1]["drained"] is True and tab[0]["drained"] is False


def test_client_disconnect_cancels_request(lm, rng):
    """Dropping the SSE connection mid-stream cancels the request on the
    replica: the batcher goes idle and its progress entry is gone."""
    rep = _mk_replica(lm, 0, batch=1)
    b = rep.batcher
    try:
        payload = json.dumps({"prompt": rng.integers(1, 90, 5).tolist(),
                              "max_new_tokens": 50}).encode()
        req = urllib.request.Request(
            rep.url + "/generate", data=payload,
            headers={"Content-Type": "application/json"})
        resp = urllib.request.urlopen(req, timeout=T)
        resp.readline()          # first event arrived: request in flight
        with rep.lock:           # stall decode so tokens remain pending
            resp.close()         # the client walks away mid-stream
            time.sleep(0.05)
        deadline = time.monotonic() + T
        while ((not b.idle or b._stream)
               and time.monotonic() < deadline):
            time.sleep(0.01)
        assert b.idle
        assert not b._stream
    finally:
        _close(rep)


def test_prefill_tier_disaggregated_parity(lm, rng):
    """A prefill-role replica primes the prompt; the decode replica lands
    the shipped K/V and streams: tokens equal the JAX solo run."""
    pre = ReplicaServer(_batcher(lm, "prefill", 1), replica_id=0).start()
    dec = _mk_replica(lm, 1)
    router = Router([dec.url], prefill_replicas=[pre.url]).start()
    try:
        for k in (7, 5):
            p = rng.integers(1, 90, k).tolist()
            out = request_generate(router.url, p, 8, timeout=T)
            assert out["tokens"] == _solo(lm, p, 8)
        assert pre.batcher.stats()["dispatches"] > 0
        assert dec.batcher.wave_counts().get("primed", 0) >= 1
    finally:
        _close(router, pre, dec)


def test_stale_push_marks_down_never_pushed_stays_up(lm, rng):
    """Aggregator staleness is a down signal for a replica that pushed
    and went silent; one that never pushed stays routable."""
    agg = ClusterAggregator(stale_after=0.2)
    agg.ingest({"host": 0, "metrics": {}})
    r0, r1 = _mk_replica(lm, 0), _mk_replica(lm, 1)
    router = Router([r0.url, r1.url], aggregator=agg).start()
    try:
        time.sleep(0.3)  # host 0's one push goes stale
        p = rng.integers(1, 90, 5).tolist()
        out = request_generate(router.url, p, 6, timeout=T)
        assert out["replica"] == 1
        assert out["tokens"] == _solo(lm, p, 6)
        tab = {row["replica"]: row for row in router.table()}
        assert tab[0]["up"] is False
        assert tab[0]["push_age_s"] is not None
        assert tab[1]["up"] is True and tab[1]["push_age_s"] is None
    finally:
        _close(router, r0, r1)


def _stall(monkeypatch, b):
    """Stall decode WITHOUT holding the replica lock (load() takes it):
    a no-op step keeps every submit queued."""
    monkeypatch.setattr(b, "step", lambda: time.sleep(0.01))


def test_replica_queue_full_maps_to_429_with_retry_after(lm, rng,
                                                         monkeypatch):
    """A capped batcher's QueueFull answers HTTP 429 with an integer
    Retry-After and `QueueFull.as_json()` — not a 400."""
    b = _batcher(lm, batch=1,
                 admission_ctl=tadmission.AdmissionController(max_queue=1))
    rep = ReplicaServer(b, replica_id=0).start()
    try:
        _stall(monkeypatch, b)
        payload = {"prompt": rng.integers(1, 90, 4).tolist(),
                   "max_new_tokens": 6}
        req = urllib.request.Request(
            rep.url + "/generate", data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        first = urllib.request.urlopen(req, timeout=T)
        first.readline()               # request 1 sits in the queue
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=T)
        e = ei.value
        assert e.code == 429
        retry_after = e.headers.get("Retry-After")
        assert retry_after is not None and int(retry_after) >= 1
        body = json.loads(e.read())
        assert body["error"] == "queue full"
        assert body["reason"] == "queue_depth"
        assert body["queue_depth"] == 1
        assert body["retry_after_s"] >= 0.5
        load = json.loads(urllib.request.urlopen(
            rep.url + "/load", timeout=T).read())
        assert load["saturated"] is True
        assert load["queued_tokens"] == 6
        assert load["retry_after_s"] > 0
        first.close()
    finally:
        _close(rep)


def test_router_rejects_fast_when_all_replicas_saturated(lm, rng,
                                                         monkeypatch):
    """With every live replica's /load saturated, the router answers 429
    with Retry-After at the front door."""
    b = _batcher(lm, batch=1,
                 admission_ctl=tadmission.AdmissionController(max_queue=1))
    rep = ReplicaServer(b, replica_id=0).start()
    router = Router([rep.url]).start()
    reg = metrics.default_registry()
    reg.reset("router/rejected")
    try:
        _stall(monkeypatch, b)
        p = rng.integers(1, 90, 4).tolist()
        req = urllib.request.Request(
            rep.url + "/generate",
            data=json.dumps({"prompt": p, "max_new_tokens": 6}).encode(),
            headers={"Content-Type": "application/json"})
        first = urllib.request.urlopen(req, timeout=T)
        first.readline()               # the lone replica is now saturated
        with pytest.raises(urllib.error.HTTPError) as ei:
            request_generate(router.url, p, 6, timeout=T)
        e = ei.value
        assert e.code == 429
        assert int(e.headers.get("Retry-After")) >= 1
        body = json.loads(e.read())
        assert body["reason"] == "saturated"
        assert body["retriable"] is True
        assert reg.get("router/rejected_429").value >= 1
        assert reg.get("router/rejected_saturated").value >= 1
        first.close()
    finally:
        _close(router, rep)


def test_priority_round_trip_and_validation(lm, pair, rng):
    """priority in the /v1/generate body (or the X-Tfde-Priority header)
    reaches the replica's submit(); an unknown class is a 400."""
    r0, r1, router = pair
    seen = []
    for rep in (r0, r1):
        orig = rep.batcher.submit

        def spy(prompt, max_new_tokens, _orig=orig, **kw):
            seen.append(kw.get("priority"))
            return _orig(prompt, max_new_tokens, **kw)

        rep.batcher.submit = spy
    p = rng.integers(1, 90, 5).tolist()
    out = request_generate(router.url, p, 6, priority="batch", timeout=T)
    assert out["tokens"] == _solo(lm, p, 6)
    assert seen == ["batch"]
    code, body = _post(router.url + "/v1/generate",
                       {"prompt": p, "max_new_tokens": 4},
                       headers={tadmission.PRIORITY_HEADER: "Best_Effort"})
    assert code == 200 and body["tokens"] == _solo(lm, p, 4)
    assert seen[-1] == "best_effort"
    n_before = len(seen)
    with pytest.raises(urllib.error.HTTPError) as ei:
        request_generate(router.url, p, 4, priority="urgent", timeout=T)
    assert ei.value.code == 400
    assert len(seen) == n_before


def test_brownout_sheds_strictly_in_priority_order(lm, rng):
    """Under fast-window SLO burn the router sheds best_effort first,
    then batch, never interactive."""
    rep = _mk_replica(lm, 0)

    def burned_tracker():
        t = SLOTracker(ttft_target_ms=1.0, objective=0.99)
        for _ in range(10):            # >= MIN_BURN_SAMPLES, all missed
            t.record(ttft_ms=1000.0)
        return t                       # fast-window burn == 100

    p = rng.integers(1, 90, 5).tolist()

    def expect_429(router, priority):
        with pytest.raises(urllib.error.HTTPError) as ei:
            request_generate(router.url, p, 4, priority=priority, timeout=T)
        assert ei.value.code == 429
        assert json.loads(ei.value.read())["reason"] == "brownout"
        assert int(ei.value.headers.get("Retry-After")) >= 1

    reg = metrics.default_registry()
    router = Router([rep.url], slo=burned_tracker(),
                    brownout_burn=8.0, brownout_burn_batch=16.0).start()
    try:
        expect_429(router, "best_effort")
        expect_429(router, "batch")
        out = request_generate(router.url, p, 4, timeout=T)
        assert out["tokens"] == _solo(lm, p, 4)
        assert reg.get("router/brownout_level").value == 2
    finally:
        _close(router)
    router = Router([rep.url], slo=burned_tracker(),
                    brownout_burn=8.0, brownout_burn_batch=1e9).start()
    try:
        expect_429(router, "best_effort")
        out = request_generate(router.url, p, 4, priority="batch",
                               timeout=T)
        assert out["tokens"] == _solo(lm, p, 4)
        assert reg.get("router/brownout_level").value == 1
    finally:
        _close(router, rep)


def _mk_booting_replica(lm, idx, phase="warmup"):
    """A replica whose externally driven boot ledger has not reached
    ready."""
    led = tboot.BootLedger(registry=metrics.Registry(),
                           compile_probe=lambda: (0, 0.0))
    led.begin(phase)
    rep = ReplicaServer(_batcher(lm), replica_id=idx, boot_ledger=led)
    return rep.start(), led


def test_readiness_matrix_no_placement_until_ready_then_flip(lm, rng):
    """A warming replica gets no placement while its sibling serves;
    /healthz and /replicas carry its state; once ready (and the router's
    /load snapshot aged out) it is placed again; /drain walks its row to
    draining, and close() the ledger."""
    r0, led = _mk_booting_replica(lm, 0)
    r1 = _mk_replica(lm, 1)
    router = Router([r0.url, r1.url]).start()
    try:
        hz = json.loads(urllib.request.urlopen(
            r0.url + "/healthz", timeout=T).read())
        assert hz == {"ok": False, "state": "warming", "replica": 0}
        outs = [request_generate(router.url, rng.integers(1, 90, 5).tolist(),
                                 6, timeout=T) for _ in range(4)]
        assert all(o["replica"] == 1 for o in outs)
        tab = {row["replica"]: row for row in router.table()}
        assert tab[0]["state"] == "warming"
        assert tab[0]["ready_seen"] is False
        assert tab[0]["up"] is True
        body = json.loads(urllib.request.urlopen(
            router.url + "/replicas", timeout=T).read())
        assert body["boot"]["0"]["state"] == "warming"
        assert body["boot"]["1"]["state"] == "ready"

        led.ready()
        time.sleep(router._load_ttl + 0.05)
        hz = json.loads(urllib.request.urlopen(
            r0.url + "/healthz", timeout=T).read())
        assert hz["ok"] is True and hz["state"] == "ready"
        p = rng.integers(1, 90, 5).tolist()
        placed = {request_generate(router.url, p, 6, timeout=T)["replica"]
                  for _ in range(4)}
        assert 0 in placed
        out = request_generate(router.url, p, 6, timeout=T)
        assert out["tokens"] == _solo(lm, p, 6)
        tab = {row["replica"]: row for row in router.table()}
        assert tab[0]["state"] == "ready" and tab[0]["ready_seen"] is True
        assert _post(router.url + "/drain", {"replica": 0})[0] == 200
        tab = {row["replica"]: row for row in router.table()}
        assert tab[0]["state"] == "draining"
    finally:
        _close(router, r0, r1)
    assert led.state == "draining"


def test_ready_require_off_restores_legacy_placement(lm, rng, monkeypatch):
    """TFDE_BOOT_READY_REQUIRE=off: a still-booting replica is placeable
    and decodes correctly."""
    monkeypatch.setenv("TFDE_BOOT_READY_REQUIRE", "off")
    r0, _led = _mk_booting_replica(lm, 0, phase="compile")
    r1 = _mk_replica(lm, 1)
    router = Router([r0.url, r1.url]).start()
    try:
        p = rng.integers(1, 90, 5).tolist()
        outs = [request_generate(router.url, p, 6, timeout=T)
                for _ in range(4)]
        assert any(o["replica"] == 0 for o in outs)
        for o in outs:
            assert o["tokens"] == _solo(lm, p, 6)
    finally:
        _close(router, r0, r1)


def test_boot_grace_shields_never_ready_from_staleness(lm, rng,
                                                       monkeypatch):
    """Within TFDE_BOOT_READY_GRACE_S a never-ready replica whose pushes
    went stale stays up (and unplaced)."""
    monkeypatch.setenv("TFDE_BOOT_READY_GRACE_S", "60")
    agg = ClusterAggregator(stale_after=0.2)
    agg.ingest({"host": 0, "metrics": {}})
    r0, _led = _mk_booting_replica(lm, 0, phase="compile")
    r1 = _mk_replica(lm, 1)
    router = Router([r0.url, r1.url], aggregator=agg).start()
    try:
        time.sleep(0.3)
        out = request_generate(router.url, rng.integers(1, 90, 5).tolist(),
                               6, timeout=T)
        assert out["replica"] == 1
        tab = {row["replica"]: row for row in router.table()}
        assert tab[0]["up"] is True
        assert tab[1]["up"] is True
    finally:
        _close(router, r0, r1)


def test_never_ready_death_books_separately_from_lost(lm, rng,
                                                      monkeypatch):
    """With the grace elapsed, a stale never-ready replica is marked down
    under router/replicas_never_ready, not router/replicas_lost."""
    monkeypatch.setenv("TFDE_BOOT_READY_GRACE_S", "0")
    reg = metrics.default_registry()
    reg.reset("router/")
    agg = ClusterAggregator(stale_after=0.2)
    agg.ingest({"host": 0, "metrics": {}})
    r0, _led = _mk_booting_replica(lm, 0, phase="restore")
    r1 = _mk_replica(lm, 1)
    router = Router([r0.url, r1.url], aggregator=agg).start()
    try:
        time.sleep(0.3)
        out = request_generate(router.url, rng.integers(1, 90, 5).tolist(),
                               6, timeout=T)
        assert out["replica"] == 1
        tab = {row["replica"]: row for row in router.table()}
        assert tab[0]["up"] is False
        assert reg.get("router/replicas_never_ready").value >= 1
        lost = reg.get("router/replicas_lost")
        assert lost is None or lost.value == 0
    finally:
        _close(router, r0, r1)


def test_deadline_shed_surfaces_as_inband_sse_error(lm, rng, monkeypatch):
    """A request shed at dequeue after its SSE stream opened surfaces as
    an in-band retriable `deadline_shed` event."""
    rep = _mk_replica(lm, 0, batch=1)
    router = Router([rep.url]).start()
    b = rep.batcher
    try:
        p = rng.integers(1, 90, 4).tolist()
        real_step = b.step
        state = {"n": 0}

        def slow_step(*a, **kw):
            state["n"] += 1
            if state["n"] < 4:
                time.sleep(0.02)
                return []
            return real_step(*a, **kw)

        monkeypatch.setattr(b, "step", slow_step)
        with pytest.raises(RuntimeError, match="deadline_shed"):
            request_generate(router.url, p, 6, ttft_deadline_ms=1.0,
                             timeout=T)
    finally:
        _close(router, rep)


def test_handlers_get_the_lock_between_steps(lm, monkeypatch):
    """While the step loop runs step after step (each releasing the GIL,
    as a CUDA sync does), a thread waiting for the replica's lock gets
    it by the next step: the lock goes in arrival order. (Under an
    ordinary lock the loop re-took it before the woken thread ran, and
    on the card tokens streamed only once a replica went idle.)"""
    rep = _mk_replica(lm, 0, batch=1)
    b = rep.batcher
    try:
        with rep.lock:
            rid = b.submit(np.asarray([1, 2, 3]), 4)
            monkeypatch.setattr(b, "step", lambda: time.sleep(0.02))
        waits = []
        for _ in range(10):
            t0 = time.perf_counter()
            with rep.lock:
                waits.append(time.perf_counter() - t0)
                assert not b.idle      # the loop keeps stepping
            time.sleep(0.005)
        assert max(waits) < 0.5, waits
    finally:
        with rep.lock:
            monkeypatch.undo()
            b.cancel(rid)
        _close(rep)


# -- across the two packages --------------------------------------------------
def _jax_replica(lm, idx, role="both", batch=2):
    jm, params, _ = lm
    b = jserver.ContinuousBatcher(jm, params, kv_quant="fp",
                                  batch_size=batch, max_len=64, role=role)
    return jrouter.ReplicaServer(b, replica_id=idx).start()


def _jclose(*servers):
    for s in servers:
        try:
            s.close()
        except OSError:
            pass


def test_port_router_in_front_of_a_jax_replica(lm, rng):
    """A port Router places on a JAX ReplicaServer beside a port one
    (drained, so every session reaches the JAX replica); the tokens equal
    the JAX solo run and the trace id rides back."""
    jrep = _jax_replica(lm, 0)
    trep = _mk_replica(lm, 1)
    router = Router([jrep.url, trep.url]).start()
    try:
        assert router.drain(1)
        for k in (5, 7):
            p = rng.integers(1, 90, k).tolist()
            out = request_generate(router.url, p, 8, timeout=T)
            assert out["replica"] == 0
            assert out["tokens"] == _solo(lm, p, 8)
            assert out["trace"] is not None
    finally:
        _close(router, trep)
        _jclose(jrep)


def test_jax_router_in_front_of_a_port_replica(lm, rng):
    """A JAX Router over a port ReplicaServer: SSE, the /load snapshot
    and the primed-free decode path; tokens equal the JAX solo run."""
    trep = _mk_replica(lm, 0)
    router = jrouter.Router([trep.url]).start()
    try:
        for k in (4, 6):
            p = rng.integers(1, 90, k).tolist()
            out = jrouter.request_generate(router.url, p, 8, timeout=T)
            assert out["replica"] == 0
            assert out["tokens"] == _solo(lm, p, 8)
        body = json.loads(urllib.request.urlopen(
            router.url + "/replicas", timeout=T).read())
        assert body["boot"]["0"]["state"] == "ready"
    finally:
        _jclose(router)
        _close(trep)


def test_jax_prefill_hands_off_to_a_port_decode_replica(lm, rng):
    """The port Router primes long prompts on a JAX prefill replica and
    hands the JAX K/V payload to a port decode replica; a short prompt
    skips the prefill tier. Tokens equal the JAX solo run."""
    jpre = _jax_replica(lm, 0, role="prefill", batch=1)
    dec = _mk_replica(lm, 0, role="decode")
    router = Router([dec.url], prefill_replicas=[jpre.url],
                    prefill_min_tokens=6).start()
    try:
        for k in (9, 6, 3):
            p = rng.integers(1, 90, k).tolist()
            out = request_generate(router.url, p, 8, timeout=T)
            assert out["tokens"] == _solo(lm, p, 8)
        assert dec.batcher.wave_counts().get("primed", 0) == 2
        assert dec.batcher.wave_counts().get("cold", 0) == 1
    finally:
        _close(router, dec)
        _jclose(jpre)
