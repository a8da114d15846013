"""The port's flight recorder (tfde_tpu_torch/observability/flightrec.py)
against the JAX package: twins of the ten tests of
`tests/test_flightrec.py` — ring eviction order, dump/load round trip,
the death hooks in real child processes (a SIGTERM dump that composes
with a prior handler, an excepthook dump on an unhandled exception) —
with every port dump read back by the JAX `flightrec.load` too, and the
dump file named by the torch.distributed rank or ``TFDE_PROCESS_ID``.
The children import the port only (no JAX)."""

import json
import os
import signal
import subprocess
import sys
import textwrap

import pytest

from tfde_tpu.observability import flightrec as jflightrec
from tfde_tpu_torch.observability import flightrec
from tfde_tpu_torch.observability.flightrec import FlightRecorder

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- ring semantics -----------------------------------------------------------
def test_ring_evicts_oldest_in_order():
    rec = FlightRecorder(capacity=4)
    for i in range(6):
        rec.record("e", i=i)
    evs = rec.events()
    assert len(evs) == 4
    assert [e["i"] for e in evs] == [2, 3, 4, 5]
    assert all(e["kind"] == "e" for e in evs)
    assert all("ts" in e for e in evs)


def test_capacity_validated():
    with pytest.raises(ValueError):
        FlightRecorder(capacity=0)
    assert flightrec.DEFAULT_CAPACITY == jflightrec.DEFAULT_CAPACITY


def test_dump_load_roundtrip(tmp_path, monkeypatch):
    """The dump is `debug/flight_<host>_<pid>.jsonl` (host from
    ``TFDE_PROCESS_ID`` with no process group) and both packages' `load`
    read it to the same events."""
    monkeypatch.setenv("TFDE_PROCESS_ID", "3")
    rec = FlightRecorder(capacity=8)
    rec.arm(str(tmp_path), install_handlers=False)
    rec.record("step", step=3, sps=1.5)
    rec.record("sentry_trip", flag=1, trip_step=3)
    path = rec.dump("roundtrip")
    assert path is not None and os.path.exists(path)
    assert os.path.basename(path) == f"flight_3_{os.getpid()}.jsonl"
    evs = flightrec.load(path)
    assert evs == jflightrec.load(path)
    kinds = [e["kind"] for e in evs]
    assert kinds == ["armed", "step", "sentry_trip", "dump"]
    assert evs[0]["host"] == 3 and evs[0]["pid"] == os.getpid()
    assert evs[1]["step"] == 3 and evs[1]["sps"] == 1.5
    assert evs[-1]["reason"] == "roundtrip"


def test_dump_unarmed_is_noop():
    rec = FlightRecorder()
    rec.record("x")
    assert rec.dump("nowhere") is None


def test_redump_replaces_whole_file(tmp_path):
    rec = FlightRecorder(capacity=16)
    rec.arm(str(tmp_path), install_handlers=False)
    rec.record("a")
    p1 = rec.dump("one")
    rec.record("b")
    p2 = rec.dump("two")
    assert p1 == p2
    evs = jflightrec.load(p2)
    assert [e["kind"] for e in evs].count("a") == 1
    assert [e["kind"] for e in evs].count("b") == 1
    assert evs[-1] == {**evs[-1], "kind": "dump", "reason": "two"}


def test_load_tolerates_truncated_tail(tmp_path):
    p = tmp_path / "flight_0_1.jsonl"
    p.write_text(json.dumps({"ts": 1.0, "kind": "ok"}) + "\n"
                 + '{"ts": 2.0, "kind": "trunc')
    evs = flightrec.load(str(p))
    assert [e["kind"] for e in evs] == ["ok"]


# -- death hooks in real processes -------------------------------------------
def _run_child(code: str, tmp_path, timeout=60):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + env.get("PYTHONPATH", "").split(os.pathsep))
    return subprocess.run(
        [sys.executable, "-c", code], env=env, cwd=str(tmp_path),
        capture_output=True, text=True, timeout=timeout,
    )


def test_sigterm_dumps_then_dies_by_signal(tmp_path):
    """SIGTERM with no prior handler: the hook dumps the ring, restores
    SIG_DFL and re-raises, so the process still dies by the signal."""
    code = textwrap.dedent(f"""
        import os, signal, sys
        from tfde_tpu_torch.observability import flightrec
        flightrec.arm({str(tmp_path)!r})
        flightrec.record("work", step=7)
        assert "jax" not in sys.modules
        os.kill(os.getpid(), signal.SIGTERM)
        raise SystemExit("signal did not kill us")
    """)
    res = _run_child(code, tmp_path)
    assert res.returncode == -signal.SIGTERM, (res.returncode, res.stderr)
    files = [f for f in os.listdir(tmp_path / "debug")
             if f.startswith("flight_")]
    assert len(files) == 1
    evs = jflightrec.load(str(tmp_path / "debug" / files[0]))
    kinds = [e["kind"] for e in evs]
    assert "work" in kinds and "sigterm" in kinds
    assert kinds[-1] == "dump"


def test_sigterm_chains_to_prior_handler(tmp_path):
    """A handler installed before arming still runs after the dump."""
    code = textwrap.dedent(f"""
        import os, signal, sys
        fired = []
        signal.signal(signal.SIGTERM, lambda s, f: fired.append(s))
        from tfde_tpu_torch.observability import flightrec
        flightrec.arm({str(tmp_path)!r})
        os.kill(os.getpid(), signal.SIGTERM)
        assert fired == [signal.SIGTERM], fired
        print("chained")
    """)
    res = _run_child(code, tmp_path)
    assert res.returncode == 0, res.stderr
    assert "chained" in res.stdout


def test_unhandled_exception_dumps(tmp_path):
    code = textwrap.dedent(f"""
        from tfde_tpu_torch.observability import flightrec
        flightrec.arm({str(tmp_path)!r})
        flightrec.record("about_to_die")
        raise RuntimeError("boom")
    """)
    res = _run_child(code, tmp_path)
    assert res.returncode == 1
    assert "RuntimeError: boom" in res.stderr
    files = os.listdir(tmp_path / "debug")
    assert len(files) == 1
    evs = jflightrec.load(str(tmp_path / "debug" / files[0]))
    kinds = [e["kind"] for e in evs]
    assert "about_to_die" in kinds and "unhandled_exception" in kinds
    err = next(e for e in evs if e["kind"] == "unhandled_exception")
    assert "boom" in err["error"]


def test_default_recorder_module_api(tmp_path, monkeypatch):
    """The module-level API appends to the default recorder; under a
    one-rank gloo group the dump is named by the rank, and arming
    initializes nothing."""
    import torch.distributed as dist

    rec = flightrec.default_recorder()
    flightrec.record("module_level_probe", n=1)
    assert any(e["kind"] == "module_level_probe" for e in rec.events())
    assert not dist.is_initialized()
    r = FlightRecorder()
    r.arm(str(tmp_path), install_handlers=False)
    assert not dist.is_initialized()
    monkeypatch.setenv("GLOO_SOCKET_IFNAME", "lo")
    store = f"file://{tmp_path / 'store'}"
    dist.init_process_group("gloo", init_method=store, rank=0, world_size=1)
    try:
        assert os.path.basename(r.dump_path()) == \
            f"flight_0_{os.getpid()}.jsonl"
        assert flightrec._host_id() == 0
    finally:
        dist.destroy_process_group()
