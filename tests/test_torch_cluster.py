"""The port's cluster bootstrap (tfde_tpu_torch.runtime.cluster) held
against the JAX package's, and a two-rank gloo bootstrap end to end.

Every case of tests/test_cluster.py runs on the same environment through
both packages' `_rank_from_tf_config` / `resolve_cluster` /
`coordinator_endpoint`: the same result (ClusterInfo fields, rank
tuples, endpoints), or the same exception type matching the same
pattern, and the same TF_CONFIG left in the environment. Then two
processes bootstrap through TFDE_* variables on a free TCP port and run
`mnist_multiworker.main` on the CPU: both report the same loss and end
with bitwise-equal parameters.
"""

import dataclasses
import json
import os
import socket

import numpy as np
import pytest

from tfde_tpu.runtime import cluster as jcluster
from tfde_tpu_torch import testing
from tfde_tpu_torch.runtime import cluster

CLUSTER = {
    "master": ["host0:2222"],
    "worker": ["host1:2222", "host2:2222"],
    "ps": ["host3:2222"],
}
_CLEAR = ("TF_CONFIG", "CLUSTER_SPEC", "JOB_NAME", "TASK_INDEX",
          "TFDE_NUM_PROCESSES", "TFDE_PROCESS_ID", "TFDE_COORDINATOR",
          "TFDE_COORD_PORT")


def _cfg(job_type, index, cluster=CLUSTER):
    return {"cluster": cluster, "task": {"type": job_type, "index": index}}


#: test_cluster.py's cases: (environment, call, pattern a raise must
#: match). The call takes either package's cluster module.
CASES = {
    "master_maps_to_rank_zero": (
        {}, lambda c: c._rank_from_tf_config(_cfg("master", 0)), None),
    "chief_alias_maps_to_rank_zero": (
        {}, lambda c: c._rank_from_tf_config(
            _cfg("chief", 0, {"chief": ["c:2222"], "worker": ["w:2222"]})),
        None),
    "worker_offset_by_one_when_master_exists[0]": (
        {}, lambda c: c._rank_from_tf_config(_cfg("worker", 0)), None),
    "worker_offset_by_one_when_master_exists[1]": (
        {}, lambda c: c._rank_from_tf_config(_cfg("worker", 1)), None),
    "worker_zero_without_chief_becomes_chief": (
        {}, lambda c: [c._rank_from_tf_config(
            _cfg("worker", i, {"worker": ["w0:2222", "w1:2222"]}))
            for i in (0, 1)], None),
    "ps_entries_dropped_from_ranking": (
        {}, lambda c: c._rank_from_tf_config(_cfg("master", 0))[0], None),
    "ps_role_refuses_to_launch": (
        {}, lambda c: c._rank_from_tf_config(_cfg("ps", 0)), "JOB_NAME=ps"),
    "malformed_cluster_spec_fails_loudly": (
        {"CLUSTER_SPEC": "{not json"}, lambda c: c.resolve_cluster(),
        "CLUSTER_SPEC"),
    "malformed_tf_config_fails_loudly": (
        {"TF_CONFIG": "]["}, lambda c: c.resolve_cluster(), "TF_CONFIG"),
    "cluster_spec_synthesis_roundtrip": (
        {"CLUSTER_SPEC": json.dumps(CLUSTER), "JOB_NAME": "worker",
         "TASK_INDEX": "1"},
        lambda c: (c.resolve_cluster(), json.loads(os.environ["TF_CONFIG"])),
        None),
    "native_contract_takes_precedence": (
        {"TFDE_NUM_PROCESSES": "4", "TFDE_PROCESS_ID": "2",
         "TFDE_COORDINATOR": "coord:1234", "TF_CONFIG": "ignored garbage"},
        lambda c: c.resolve_cluster(), None),
    "no_env_is_local_single_process": (
        {}, lambda c: c.resolve_cluster(), None),
    "coordinator_endpoint_derives_port": (
        {}, lambda c: (c.coordinator_endpoint("host0:2222"),
                       c.coordinator_endpoint("host0")), None),
    "coordinator_endpoint_env_override": (
        {"TFDE_COORD_PORT": "9999"},
        lambda c: c.coordinator_endpoint("host0:2222"), None),
}


def _plain(value):
    """ClusterInfo (either package's) -> its fields and properties."""
    if dataclasses.is_dataclass(value):
        return (dataclasses.astuple(value), value.is_chief,
                value.is_distributed)
    if isinstance(value, (list, tuple)):
        return type(value)(_plain(v) for v in value)
    return value


def _outcome(module, env, call, monkeypatch):
    for var in _CLEAR:
        monkeypatch.delenv(var, raising=False)
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    # the synthesis writes TF_CONFIG: setenv makes monkeypatch restore it
    monkeypatch.setenv("TF_CONFIG", env.get("TF_CONFIG", ""))
    try:
        result = ("ok", _plain(call(module)))
    except (ValueError, RuntimeError) as e:
        result = (type(e), str(e))
    return result, os.environ.get("TF_CONFIG")


@pytest.mark.parametrize("case", list(CASES))
def test_cluster_case_matches_jax(case, monkeypatch):
    env, call, pattern = CASES[case]
    want, want_env = _outcome(jcluster, env, call, monkeypatch)
    got, got_env = _outcome(cluster, env, call, monkeypatch)
    if pattern is None:
        assert want[0] == "ok", want
        assert got == want
    else:
        assert got[0] is want[0]
        assert pattern in want[1] and pattern in got[1]
    assert got_env == want_env


def test_single_process_bootstrap_builds_no_group(monkeypatch):
    import torch.distributed as dist

    for var in _CLEAR:
        monkeypatch.delenv(var, raising=False)
    info = cluster.bootstrap(device="cpu")
    assert info == cluster.last_info() and not info.is_distributed
    assert not cluster.initialized() and not dist.is_initialized()


def test_entry_point_runs_on_the_cpu_only_when_asked(monkeypatch, tmp_path,
                                                    caplog):
    """Without --device the entry point asks for CUDA and raises here; with
    --device cpu and --model-dir it checkpoints, and a second run with
    more epochs resumes there and runs only the steps left."""
    import logging

    import torch

    from tfde_tpu_torch import mnist_multiworker

    for var in _CLEAR:
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mnist_multiworker.main(["--steps-per-epoch", "1", "--epochs", "1"])
    argv = ["--device", "cpu", "--model-dir", str(tmp_path),
            "--steps-per-epoch", "2"]
    state, _ = mnist_multiworker.main(argv + ["--epochs", "2"])
    assert state.step == 4
    with caplog.at_level(logging.INFO):
        state, metrics = mnist_multiworker.main(argv + ["--epochs", "3"])
    assert state.step == 6 and np.isfinite(metrics["loss"])
    assert "resuming at step 4 of 6" in caplog.text
    assert sorted(os.listdir(tmp_path / "checkpoints")) == ["4", "6"]


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_rank_gloo_bootstrap_runs_the_entry_point():
    port = _free_port()
    base = {"TFDE_NUM_PROCESSES": "2", "TFDE_COORDINATOR": "127.0.0.1:2222",
            "TFDE_COORD_PORT": str(port)}
    argv = ["--device", "cpu", "--epochs", "1", "--steps-per-epoch", "3"]
    out = testing.run_ranks(
        testing.bootstrap_worker,
        [({**base, "TFDE_PROCESS_ID": str(r)}, argv) for r in range(2)],
        timeout=180)
    for r, o in enumerate(out):
        assert (o["rank"], o["process_id"], o["world"]) == (r, r, 2)
        assert o["backend"] == "gloo" and o["step"] == 3
        assert np.isfinite(o["metrics"]["loss"])
    assert out[0]["metrics"] == out[1]["metrics"]
    for k, v in out[0]["params"].items():
        assert np.array_equal(v, out[1]["params"][k]), k
