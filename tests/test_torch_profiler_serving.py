"""The serving half of the port's profiler (tfde_tpu_torch/observability/
profiler.py) on the CPU's torch profiler: the twins of the serving tests
of `tests/test_profiler.py` — the artifact index and its retention, the
trigger hub's cooldown, dedupe, refusal, disabled and broken-sink
contracts and its knobs, `RoundWindowProfiler` arm, refusal and window,
the SLO-burn and straggler drills, the push-reply command channel, the
two-process coordinated capture (the child imports the port only) and
``POST /profile`` on a live replica through the router — plus the
port's own contracts: one window per process (a second profiler's arm,
another replica's ``POST /profile`` included, is refused while the first
is armed or capturing), the window's Chrome trace on disk with CPU
activity only on the CPU, and a window that fails to open never raising
into the step loop."""

import json
import os
import subprocess
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from tfde_tpu_torch.observability import metrics, profiler
from tfde_tpu_torch.observability.profiler import (
    ProfileArtifacts,
    ProfileTrigger,
    RoundWindowProfiler,
)
from tfde_tpu_torch.testing import one_thread

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: one intra-op torch thread for the module (`testing.one_thread`)
_one_thread = pytest.fixture(autouse=True, scope="module")(one_thread)

#: the timeout of every HTTP call in this file, seconds
T = 30


@pytest.fixture(autouse=True)
def _fresh_hub():
    profiler.reset_hub()
    yield
    profiler.reset_hub()


class _FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def _work():
    """A little CPU work for a window to record."""
    torch.randn(64, 64) @ torch.randn(64, 64)


# -- artifact index ----------------------------------------------------------
def test_artifact_index_retention(tmp_path):
    arts = ProfileArtifacts(str(tmp_path), retain=2)
    for i in range(5):
        path = arts.record(f"reason{i}", "round", i, i + 2,
                           traces=["t1", "t2"], logdir=str(tmp_path))
        assert path and os.path.exists(path)
    recs = profiler.list_artifacts(str(tmp_path))
    assert len(recs) == 2
    assert [r["reason"] for r in recs] == ["reason3", "reason4"]
    assert recs[-1]["traces"] == ["t1", "t2"]
    assert recs[-1]["kind"] == "round"
    assert recs[-1]["start"] == 4 and recs[-1]["stop"] == 6
    assert recs[-1]["host"] == 0 and recs[-1]["pid"] == os.getpid()
    assert ProfileArtifacts(None).record("r", "round", 0, 1) is None


# -- trigger hub -------------------------------------------------------------
def test_trigger_cooldown_and_dedupe():
    clock = _FakeClock()
    hub = ProfileTrigger(cooldown_s=10.0, dedupe_s=60.0, enabled=True,
                         clock=clock)
    calls = []
    hub.register("sink", lambda r, s, i: (calls.append((r, s)), True)[1])
    assert hub.trigger("slo_burn_ttft", span=4)
    assert calls == [("slo_burn_ttft", 4)]
    assert not hub.trigger("recompile_storm")
    clock.t += 11
    assert not hub.trigger("slo_burn_ttft")
    assert hub.trigger("recompile_storm", span=2)
    clock.t += 61
    assert hub.trigger("slo_burn_ttft", span=4)
    assert len(calls) == 3


def test_trigger_refusal_preserves_budget():
    clock = _FakeClock()
    hub = ProfileTrigger(cooldown_s=10.0, dedupe_s=60.0, clock=clock)
    hub.register("refuser", lambda r, s, i: False)
    assert not hub.trigger("slo_burn_ttft")
    hub.register("armer", lambda r, s, i: True)
    assert hub.trigger("slo_burn_ttft")


def test_trigger_disabled_and_broken_sinks():
    hub = ProfileTrigger(cooldown_s=0.0, dedupe_s=0.0, enabled=False,
                         clock=_FakeClock())
    hub.register("sink", lambda r, s, i: True)
    assert not hub.trigger("anything")
    hub2 = ProfileTrigger(cooldown_s=0.0, dedupe_s=0.0, enabled=True,
                          clock=_FakeClock())
    hub2.register("broken", lambda r, s, i: 1 / 0)
    got = []
    assert hub2.trigger("x",
                        extra_sink=lambda r, s, i: (got.append(i), True)[1])
    assert got and got[0] == {}


def test_trigger_knob_defaults(monkeypatch):
    monkeypatch.setenv("TFDE_PROFILE_COOLDOWN_S", "5.5")
    monkeypatch.setenv("TFDE_PROFILE_DEDUPE_S", "7.5")
    monkeypatch.setenv("TFDE_PROFILE_TRIGGERS", "off")
    hub = ProfileTrigger()
    assert hub.cooldown_s == 5.5 and hub.dedupe_s == 7.5
    assert not hub.enabled


# -- serving round windows ---------------------------------------------------
def test_round_window_capture(tmp_path):
    """A real CPU window: opens at round 10, closes at 14, writes its
    Chrome trace (CPU activity only: the profiled device is the CPU) and
    an artifact with the round range, the traces, the trace file and the
    window's wall seconds."""
    arts = ProfileArtifacts(str(tmp_path))
    rp = RoundWindowProfiler(str(tmp_path), artifacts=arts, device="cpu")
    try:
        with pytest.raises(ValueError):
            rp.arm(span=0)
        assert rp.arm(span=4, reason="slo_burn_tpot")
        assert not rp.arm(span=4)               # already armed
        rp.on_round(10, traces=["aaa"])         # opens; window [10, 14)
        with torch.profiler.record_function("serving/decode"):
            _work()
        rp.on_round(12, traces=["bbb"])
        assert rp.windows_traced == 0
        rp.on_round(14, traces=["aaa"])         # closes
        assert rp.windows_traced == 1
        recs = profiler.list_artifacts(str(tmp_path))
        assert len(recs) == 1
        rec = recs[0]
        assert rec["reason"] == "slo_burn_tpot" and rec["kind"] == "round"
        assert rec["traces"] == ["aaa", "bbb"]
        assert rec["start"] == 10 and rec["stop"] == 14
        assert rec["wall_s"] > 0
        assert rec["trace_file"] == rp.last_trace_file
        with open(rec["trace_file"]) as f:
            events = json.load(f)["traceEvents"]
        cats = {e.get("cat") for e in events}
        assert "kernel" not in cats             # no CUDA activity
        assert any(e.get("name") == "serving/decode" for e in events)
        assert rp.arm(span=2, reason="again")   # consumed: re-armable
    finally:
        rp.close()
    assert not RoundWindowProfiler(None).arm(span=2)


def test_one_window_per_process(tmp_path):
    """A second profiler's arm is refused while the first is armed and
    while it captures; after the window closes (or `close()` drops an
    armed one) the second arms."""
    a = RoundWindowProfiler(str(tmp_path / "a"), device="cpu")
    b = RoundWindowProfiler(str(tmp_path / "b"), device="cpu")
    try:
        assert a.arm(span=1, reason="first")
        assert not b.arm(span=1)               # a armed
        a.on_round(1)
        assert not b.arm(span=1)               # a capturing
        a.on_round(2)
        assert a.windows_traced == 1
        assert b.arm(span=1)                   # the window is free
        assert not a.arm(span=1)
        b.close()                              # drops the armed window
        assert a.arm(span=1)
    finally:
        a.close()
        b.close()


def test_window_that_fails_to_open_never_raises(tmp_path, monkeypatch):
    """A profiler that cannot start is logged, the window released and
    the step loop's `on_round` returns normally."""
    def broken(cuda):
        raise RuntimeError("profiler unavailable")

    monkeypatch.setattr(profiler, "_start_trace", broken)
    rp = RoundWindowProfiler(str(tmp_path), device="cpu")
    assert rp.arm(span=2)
    rp.on_round(1, traces=["t"])               # must not raise
    assert rp.windows_traced == 0
    other = RoundWindowProfiler(str(tmp_path), device="cpu")
    assert other.arm(span=1)                   # released
    other.close()


# -- live drills ---------------------------------------------------------------
def test_slo_burn_drill_produces_stamped_artifact(tmp_path, monkeypatch):
    """A forced TTFT SLO burn arms a serving capture through the hub and
    leaves an artifact stamped with the reason and the in-flight trace
    ids; a sustained burn does not re-trigger."""
    from tfde_tpu_torch.observability.slo import SLOTracker

    monkeypatch.setenv("TFDE_PROFILE_SPAN", "3")
    arts = ProfileArtifacts(str(tmp_path))
    rp = RoundWindowProfiler(str(tmp_path), artifacts=arts, device="cpu")
    profiler.hub().register("serve_round_window", rp.trigger_sink)
    reg = metrics.Registry()
    cap = metrics.default_registry().histogram("profile/capture")
    before_cap = cap.count
    try:
        tracker = SLOTracker(ttft_target_ms=100.0, objective=0.99,
                             registry=reg)
        assert tracker.burn_threshold == 10.0
        for _ in range(10):
            tracker.record(ttft_ms=500.0)
        rp.on_round(1, traces=["req-trace-1"])
        _work()
        rp.on_round(5, traces=["req-trace-2"])
    finally:
        profiler.hub().unregister("serve_round_window")
    recs = profiler.list_artifacts(str(tmp_path))
    assert len(recs) == 1
    assert recs[0]["reason"] == "slo_burn_ttft"
    assert "req-trace-1" in recs[0]["traces"]
    assert "req-trace-2" in recs[0]["traces"]
    assert cap.count >= before_cap + 2         # start + stop observed
    before = len(profiler.list_artifacts(str(tmp_path)))
    for _ in range(5):
        tracker.record(ttft_ms=500.0)
    assert len(profiler.list_artifacts(str(tmp_path))) == before
    rp.close()


def test_straggler_drill_triggers_and_broadcasts():
    from tfde_tpu_torch.observability.aggregate import ClusterAggregator

    clock = _FakeClock()
    fired = []
    profiler.hub().register("probe", lambda r, s, i: (fired.append((r, i)),
                                                      True)[1])
    agg = ClusterAggregator(
        registry=metrics.Registry(), straggler_factor=1.5,
        coordinate=True, clock=clock,
        on_straggler=lambda h, r: None, on_stale=lambda h, a: None,
    )

    def push(host, step_s, count):
        agg.ingest({"host": host, "metrics": {
            "train/step/sum": step_s * count, "train/step/count": count,
        }})

    for i in range(1, 4):
        push(0, 0.1, i)
        push(1, 1.0, i)
    assert fired and fired[0][0] == "straggler"
    assert fired[0][1]["host"] == 1
    cmd = agg.pending_profile(0)
    assert cmd and cmd["reason"] == "straggler"
    assert agg.pending_profile(0) is None
    assert agg.pending_profile(1)["id"] == cmd["id"]


def test_push_reply_delivers_coordinated_command():
    from tfde_tpu_torch.observability.aggregate import _apply_push_reply

    got = []
    profiler.hub().register("probe", lambda r, s, i: (got.append((r, s, i)),
                                                      True)[1])
    _apply_push_reply(b"ok\n")
    assert not got
    _apply_push_reply(json.dumps(
        {"ok": True, "profile": {"id": 3, "reason": "straggler",
                                 "span": 5}}).encode())
    assert len(got) == 1
    reason, span, info = got[0]
    assert reason == "straggler" and span == 5
    assert info["coordinated"] is True


# -- two-process coordinated capture ----------------------------------------
_CHILD = """
import os, sys, time
model_dir, url = sys.argv[1], sys.argv[2]
from tfde_tpu_torch.observability import aggregate, profiler
assert "jax" not in sys.modules
rp = profiler.RoundWindowProfiler(
    model_dir, artifacts=profiler.ProfileArtifacts(model_dir), device="cpu")
profiler.hub().register("child_round", rp.trigger_sink)
rounds, deadline = 0, time.time() + 60
while time.time() < deadline:
    aggregate.push_once(url, host=7)
    for _ in range(4):           # drive decode rounds
        rounds += 1
        rp.on_round(rounds, traces=["child-req"])
    if profiler.list_artifacts(model_dir):
        print("CAPTURED", flush=True)
        sys.exit(0)
    time.sleep(0.1)
print("TIMEOUT", flush=True)
sys.exit(1)
"""


def test_two_process_coordinated_capture(tmp_path):
    """A trigger on the chief leaves artifacts on both hosts: locally via
    its own sink, and on a pushing port process via the /push reply (the
    chief's endpoint is the JAX MetricsServer over the port aggregator:
    the port has no MetricsServer yet)."""
    from tfde_tpu.observability.exposition import MetricsServer
    from tfde_tpu_torch.observability.aggregate import ClusterAggregator

    chief_dir = str(tmp_path / "chief")
    child_dir = str(tmp_path / "child")
    os.makedirs(child_dir)
    reg = metrics.Registry()
    agg = ClusterAggregator(registry=reg, coordinate=True,
                            on_straggler=lambda h, r: None,
                            on_stale=lambda h, a: None)
    srv = MetricsServer(port=0, host="127.0.0.1", registry=reg,
                        aggregator=agg)
    rp = RoundWindowProfiler(chief_dir, artifacts=ProfileArtifacts(chief_dir),
                             device="cpu")
    profiler.hub().register("chief_round", rp.trigger_sink)
    script = tmp_path / "child.py"
    script.write_text(_CHILD)
    env = dict(os.environ,
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    child = subprocess.Popen(
        [sys.executable, str(script), child_dir,
         f"http://127.0.0.1:{srv.port}/push"],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, text=True,
    )
    try:
        deadline = time.monotonic() + 60
        while 7 not in agg.hosts() and time.monotonic() < deadline:
            time.sleep(0.05)
        assert 7 in agg.hosts(), "child never pushed"
        assert profiler.trigger("straggler_drill", span=3)
        for r in range(1, 6):
            rp.on_round(r, traces=["chief-req"])
        out, _ = child.communicate(timeout=90)
    finally:
        child.kill()
        srv.close()
        profiler.hub().unregister("chief_round")
        rp.close()
    assert "CAPTURED" in out, f"child saw no coordinated capture: {out!r}"
    chief_recs = profiler.list_artifacts(chief_dir)
    child_recs = profiler.list_artifacts(child_dir)
    assert chief_recs and chief_recs[0]["reason"] == "straggler_drill"
    assert child_recs and child_recs[0]["reason"] == "straggler_drill"
    assert child_recs[0]["traces"] == ["child-req"]


# -- serving front door ------------------------------------------------------
def test_replica_post_profile_end_to_end(tmp_path):
    """POST /profile through the router arms replica 0's decode-round
    window and replica 1 (same process) refuses with 409; a direct second
    arm is a 409 too; served traffic closes the window, whose artifact
    lands under replica 0's model_dir with the operator's reason."""
    from tfde_tpu_torch.inference.router import (
        ReplicaServer, Router, request_generate)
    from tfde_tpu_torch.inference.server import ContinuousBatcher
    from tfde_tpu_torch.models.gpt import gpt_tiny_test

    model = gpt_tiny_test(device="cpu", seed=1)
    dirs = [str(tmp_path / f"r{i}") for i in range(2)]
    reps = [ReplicaServer(ContinuousBatcher(model, batch_size=2, max_len=64,
                                            device="cpu"),
                          replica_id=i, model_dir=dirs[i]).start()
            for i in range(2)]
    router = Router([r.url for r in reps]).start()
    try:
        def post(url, payload):
            req = urllib.request.Request(
                url, data=json.dumps(payload).encode(),
                headers={"Content-Type": "application/json"}, method="POST")
            try:
                with urllib.request.urlopen(req, timeout=T) as resp:
                    return resp.status, json.loads(resp.read())
            except urllib.error.HTTPError as e:
                return e.code, json.loads(e.read())

        code, out = post(f"{router.url}/profile",
                         {"span": 2, "reason": "operator_drill"})
        assert code == 200
        assert out["replicas"] == [
            {"replica": 0, "armed": True, "reason": "operator_drill"},
            {"replica": 1, "armed": False, "reason": "operator_drill"}]
        code2, out2 = post(f"{reps[0].url}/profile", {"span": 2})
        assert code2 == 409 and out2["armed"] is False
        deadline = time.monotonic() + 60
        while (not profiler.list_artifacts(dirs[0])
               and time.monotonic() < deadline):
            request_generate(reps[0].url + "/generate",
                             np.asarray([5, 6, 7]), 8, timeout=T)
        recs = profiler.list_artifacts(dirs[0])
        assert recs, "no artifact after served traffic"
        assert recs[0]["reason"] == "operator_drill"
        assert recs[0]["kind"] == "round"
        assert os.path.exists(recs[0]["trace_file"])
        assert profiler.list_artifacts(dirs[1]) == []
        assert all(r.loop_alive for r in reps)
    finally:
        router.close()
        for r in reps:
            r.close()
