"""Preemption safety of the port's Estimator (tfde_tpu_torch.training
.lifecycle with tfde_tpu_torch.resilience.preemption), on the CPU.

- A child process (`python -m tfde_tpu_torch.testing`, the verify recipe
  at a small size: 512 images, batch 32, a checkpoint every 10 steps)
  raises SIGTERM in itself after step 12: it dies by the signal with a
  committed checkpoint at step 12 beside the periodic one at 10, and a
  resumed run ends with the bits of an uninterrupted one, BatchNormCNN
  with dropout 0.5 on (the port of tests/test_preemption.py::
  test_sigterm_saves_and_resume_is_bit_exact). Each run is a child of its
  own with one CPU thread, as there.
- The guard is inert off the main thread, and its first signal restores
  the previous handler (tests/test_preemption.py).
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time

from tfde_tpu_torch.checkpoint.manager import CheckpointManager
from tfde_tpu_torch.resilience.preemption import PreemptionGuard

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MAX_STEPS, KILL_AFTER = 30, 12


def _child(tmp_path, tag, model_dir, kill_after=None):
    out = str(tmp_path / f"{tag}.json")
    argv = [sys.executable, "-m", "tfde_tpu_torch.testing", model_dir, out,
            "--device", "cpu", "--max-steps", str(MAX_STEPS), "--n-train",
            "512", "--batch", "32", "--save-every", "10"]
    if kill_after is not None:
        argv += ["--kill-after", str(kill_after)]
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(argv, env=env, capture_output=True, text=True,
                          timeout=240)
    if not os.path.exists(out):
        return proc, None
    with open(out) as f:
        return proc, json.load(f)


def test_sigterm_saves_and_resume_is_bit_exact(tmp_path):
    """BatchNormCNN with dropout 0.5 on: the masks of each step come from
    (seed + 1, step), so the resumed run draws the uninterrupted run's."""
    proc, a = _child(tmp_path, "a", str(tmp_path / "dir_a"))
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert a["step"] == MAX_STEPS and a["resumed_from"] == 0

    dir_b = str(tmp_path / "dir_b")
    proc, b = _child(tmp_path, "b", dir_b, kill_after=KILL_AFTER)
    # killed BY the re-raised signal after the save, not a clean exit
    assert proc.returncode == -signal.SIGTERM, proc.stderr[-2000:]
    assert b is None  # train() never returned
    assert "checkpoint at step 12 committed" in proc.stderr
    mngr = CheckpointManager(os.path.join(dir_b, "checkpoints"))
    assert mngr.all_steps() == [10, KILL_AFTER]

    proc, c = _child(tmp_path, "c", dir_b)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert c["resumed_from"] == KILL_AFTER and c["step"] == MAX_STEPS
    assert c["digest"] == a["digest"]


def test_preemption_guard_inert_off_main_thread():
    results = {}

    def run():
        g = PreemptionGuard()
        with g:
            results["installed"] = bool(g._prev)
        results["ok"] = True

    t = threading.Thread(target=run)
    t.start()
    t.join(10)
    assert not t.is_alive()
    assert results.get("ok") and results.get("installed") is False


def test_preemption_guard_sets_flag_and_restores_handler():
    seen = []
    prev = signal.signal(signal.SIGTERM, lambda s, f: seen.append(s))
    try:
        def kill_and_settle(done):
            os.kill(os.getpid(), signal.SIGTERM)
            for _ in range(500):
                if done():
                    return
                time.sleep(0.01)
            raise AssertionError("signal handler never ran")

        g = PreemptionGuard()
        with g:
            kill_and_settle(lambda: g.fired is not None)
            assert g.fired == signal.SIGTERM and seen == []
            # the first signal restored OUR handler (the escape hatch)
            kill_and_settle(lambda: len(seen) == 1)
        kill_and_settle(lambda: len(seen) == 2)
        assert seen == [signal.SIGTERM, signal.SIGTERM]
    finally:
        signal.signal(signal.SIGTERM, prev)
