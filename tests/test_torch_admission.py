"""The port's admission control (tfde_tpu_torch/inference/admission.py and
the batcher's gate, priority lanes, deadline shedding, progress stream and
``serving/batcher/*`` gauges) against the JAX package.

- `AdmissionController`: both packages' controllers give the same
  reasons, the same Retry-After seconds (within 1e-12: the same float
  arithmetic) and the same `QueueFull.as_json()` bodies, with and without
  the kv block, over one sequence of `note_drain`, `would_reject`, `check`
  and `retry_after_s` calls, and `validate_priority` agrees on every
  spelling (the port's `submit` used to compare the raw string, so
  "BATCH", " batch " and "" raised there).
- Through the batcher, on `gpt_tiny_test`'s weights shared by
  `from_flax_params`, each admission scenario of `tests/test_server.py`
  (`testing.ADMISSION_SCENARIOS`: the depth cap, the token cap, the
  priority order, the deadline shed, forced overload, the KV-headroom gate,
  its env drill under ``TFDE_CAPACITY_BUDGET_BYTES=64``, default-off, and
  the progress stream) gives the same outcome in both packages: the
  admitted requests' greedy tokens (exact), the rejections' reasons,
  depths and kv blocks (`headroom_rows`, `rows_active`, `rows_free`), the
  shed counters, `was_shed` answering once, and the finish order.
- The gauges the drain rate and the queue publish, and `trace=` other
  than None refusing.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfde_tpu.inference import admission as jadmission
from tfde_tpu.inference import server as jserver
from tfde_tpu.models.gpt import gpt_tiny_test as j_tiny
from tfde_tpu.observability import metrics as jmetrics
from tfde_tpu_torch import testing
from tfde_tpu_torch.inference import admission as tadmission
from tfde_tpu_torch.inference import server as tserver
from tfde_tpu_torch.models.flax_weights import from_flax_params
from tfde_tpu_torch.models.gpt import gpt_tiny_test
from tfde_tpu_torch.observability import metrics as tmetrics
from tfde_tpu_torch.testing import one_thread

#: one intra-op torch thread for the module (`testing.one_thread`)
_one_thread = pytest.fixture(autouse=True, scope="module")(one_thread)

#: the scenarios' prompt (tests/test_server.py draws 3-4 ids in [1, 90))
PROMPT = np.asarray([17, 5, 60, 33])
#: Retry-After seconds: both controllers run the same float arithmetic
RETRY_TOL = 1e-12


@pytest.fixture(scope="module")
def lm():
    jm = j_tiny()
    params = jm.init(jax.random.key(1), jnp.zeros((1, 8), jnp.int32))["params"]
    tm = gpt_tiny_test(device="cpu")
    tm.load_state_dict(from_flax_params(jax.tree.map(np.asarray, params)))
    return jm, params, tm


def _makers(lm):
    jm, params, tm = lm
    return (lambda **kw: jserver.ContinuousBatcher(
                jm, params, kv_quant="fp", **kw),
            lambda **kw: tserver.ContinuousBatcher(
                tm, kv_quant="fp", device="cpu", **kw))


# --------------------------------------------------------------------------
# the controller
# --------------------------------------------------------------------------

def _controller_trace(adm) -> list:
    """One sequence of calls on a fresh controller of package `adm`: the
    results in order (reasons, seconds, 429 bodies)."""
    out = []
    ctl = adm.AdmissionController(max_queue=3, max_queued_tokens=40,
                                  ttft_deadline_ms=250.0,
                                  min_headroom_rows=2)
    out.append(("defaults", ctl.enabled, ctl.ttft_deadline_ms,
                ctl.retry_after_s(100)))
    for n, dt in ((120, 0.5), (0, 1.0), (80, 0.25), (33, 0.0), (500, 1.7),
                  (7, 0.02)):
        ctl.note_drain(n, dt)
        out.append(("drain", ctl.drain_rate_tps))
    for backlog in (0, 1, 37, 10_000, 10 ** 7):
        out.append(("retry", ctl.retry_after_s(backlog)))
    for args, kw in (((0, 0, 1), {}), ((3, 0, 1), {}), ((2, 39, 1), {}),
                     ((2, 39, 2), {}), ((0, 0, 1), {"headroom_rows": 1}),
                     ((0, 0, 1), {"headroom_rows": 2}),
                     ((0, 0, 1), {"headroom_rows": None})):
        out.append(("would_reject", ctl.would_reject(*args, **kw)))
    kv = {"headroom_rows": 1, "rows_active": 3, "rows_free": 1,
          "used_bytes": 4096.0}
    for args, kw in (((5, 10, 4), {}), ((1, 38, 4), {}),
                     ((0, 0, 6), {"headroom_rows": 1, "kv": kv,
                                  "drain_tokens": 900}),
                     ((0, 0, 6), {"headroom_rows": 1, "kv": kv}),
                     ((0, 0, 6), {"headroom_rows": 5, "kv": kv})):
        try:
            ctl.check(*args, **kw)
            out.append(("admitted",))
        except adm.QueueFull as e:
            out.append(("rejected", e.reason, e.queue_depth, e.queued_tokens,
                        e.retry_after_s, e.as_json(), str(e)))
    adm.force_overload(5.0)
    try:
        out.append(("forced", adm.overload_active(),
                    ctl.would_reject(0, 0, 1)))
    finally:
        adm.clear_overload()
    out.append(("cleared", adm.overload_active(), ctl.would_reject(0, 0, 1)))
    return out


def test_controller_matches_jax():
    """The same calls give the same results: reasons, queue figures, the
    429 bodies (with and without kv) and the messages exactly; the drain
    EWMA and the Retry-After seconds within RETRY_TOL."""
    got, want = _controller_trace(tadmission), _controller_trace(jadmission)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g[0] == w[0]
        for a, b in zip(g[1:], w[1:]):
            if isinstance(a, float) and not isinstance(a, bool):
                assert abs(a - b) <= RETRY_TOL, (g, w)
            else:
                assert a == b, (g, w)
    bodies = [g[5] for g in got if g[0] == "rejected"]
    assert [("kv" in b) for b in bodies] == [False, False, True, True]
    assert tadmission.PRIORITIES == jadmission.PRIORITIES
    assert tadmission.PRIORITY_RANK == jadmission.PRIORITY_RANK
    assert tadmission.PRIORITY_HEADER == jadmission.PRIORITY_HEADER
    assert (tadmission.MIN_RETRY_AFTER_S, tadmission.MAX_RETRY_AFTER_S) == (
        jadmission.MIN_RETRY_AFTER_S, jadmission.MAX_RETRY_AFTER_S)
    # the lever is each package's own state
    tadmission.force_overload(5.0)
    try:
        assert not jadmission.overload_active()
    finally:
        tadmission.clear_overload()


def test_controller_knobs_match_jax_and_refuse_junk():
    """The TFDE_ADMIT_* knobs give both controllers the same caps; an
    unreadable value raises in the port (ROADMAP queue 3's knob
    deviation) where the JAX reader warns and falls back."""
    env = dict(TFDE_ADMIT_MAX_QUEUE="7", TFDE_ADMIT_MAX_QUEUED_TOKENS="300",
               TFDE_ADMIT_TTFT_DEADLINE_MS="1500.5",
               TFDE_ADMIT_KV_HEADROOM="2")
    with testing.env_set(**env):
        t = tadmission.AdmissionController()
        j = jadmission.AdmissionController()
    for attr in ("max_queue", "max_queued_tokens", "ttft_deadline_ms",
                 "min_headroom_rows", "enabled"):
        assert getattr(t, attr) == getattr(j, attr)
    assert (t.max_queue, t.ttft_deadline_ms) == (7, 1500.5)
    for name, bad in (("TFDE_ADMIT_MAX_QUEUE", "ten"),
                      ("TFDE_ADMIT_MAX_QUEUED_TOKENS", "-4"),
                      ("TFDE_ADMIT_TTFT_DEADLINE_MS", "soon"),
                      ("TFDE_ADMIT_KV_HEADROOM", "1.5")):
        with testing.env_set(**{name: bad}):
            with pytest.raises(ValueError, match=name):
                tadmission.AdmissionController()


@pytest.mark.parametrize("spelling", [None, "", "BATCH", " batch ",
                                      "Best_Effort", "interactive", "urgent"])
def test_validate_priority_matches_jax(lm, spelling):
    """`validate_priority` normalizes (strip, lower case; None and '' are
    interactive) and refuses an unknown class as JAX's does, and the
    port's `submit` queues each spelling in the lane JAX's queues it in
    (or refuses it, leaving the queue empty)."""
    make_j, make_t = _makers(lm)
    outcomes = []
    for adm, make in ((jadmission, make_j), (tadmission, make_t)):
        srv = make(batch_size=1, max_len=48)
        try:
            norm = adm.validate_priority(spelling)
        except ValueError:
            norm = "refused"
        try:
            srv.submit(PROMPT, 2, priority=spelling)
            lanes = srv._queue.depths()
        except ValueError as e:
            assert "priority" in str(e)
            lanes = ("refused", len(srv._queue), srv._next_id)
        outcomes.append((norm, lanes))
    assert outcomes[0] == outcomes[1]
    if spelling == "urgent":
        assert outcomes[1] == ("refused", ("refused", 0, 0))


# --------------------------------------------------------------------------
# the batcher
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(testing.ADMISSION_SCENARIOS))
def test_admission_scenario_matches_jax(lm, name):
    """Each scenario's assertions (the JAX tests') hold in both packages,
    and the outcomes are equal: greedy tokens exact, rejections, kv
    blocks, shed counters, was_shed, the finish order."""
    make_j, make_t = _makers(lm)
    want = testing.admission_scenario(name, make_j, jadmission,
                                      jmetrics.default_registry(), PROMPT)
    got = testing.admission_scenario(name, make_t, tadmission,
                                     tmetrics.default_registry(), PROMPT)
    assert got == want


def test_batcher_gauges_and_drain_rate(lm):
    """After each step the serving/batcher/* gauges hold the queue, the
    rows, the backlog and the drain rate as the JAX batcher's do (the
    counts exactly; the drain rate, a wall-clock figure, positive on
    both); a trace id raises until tracing is ported."""
    make_j, make_t = _makers(lm)
    names = ("queue_depth", "free_rows", "outstanding_tokens",
             "queued_tokens", "rounds", "generated", "dispatches", "syncs")
    seen = []
    for make, reg in ((make_j, jmetrics.default_registry()),
                      (make_t, tmetrics.default_registry())):
        reg.reset("serving/batcher/")
        srv = make(batch_size=2, max_len=48)
        for n in (6, 3, 5, 4):
            srv.submit(PROMPT, n)
        trace = []
        while not srv.idle:
            srv.step()
            snap = reg.scalars("serving/batcher/")
            trace.append([snap[f"serving/batcher/{k}"] for k in names])
            assert snap["serving/batcher/drain_rate_tps"] > 0
            assert (snap["serving/batcher/outstanding_tokens"]
                    == srv.outstanding_tokens)
        assert srv.admission.drain_rate_tps > 0
        seen.append(trace)
    assert seen[0] == seen[1]
    srv = make_t(batch_size=1, max_len=48)
    with pytest.raises(NotImplementedError, match="item 4"):
        srv.submit(PROMPT, 2, trace="abc")
    assert srv._next_id == 0 and not srv._queue


def test_cancel_drops_deadline_and_stream(lm):
    """`cancel` of a queued and of an active request drops the stream
    entry, the deadline and the priority, as the JAX batcher's does; the
    freed row then serves the JAX tokens."""
    make_j, make_t = _makers(lm)
    outs = []
    for make in (make_j, make_t):
        srv = make(batch_size=1, max_len=64)
        srv.enable_progress()
        active = srv.submit(PROMPT, 40)
        queued = srv.submit(PROMPT, 6, ttft_deadline_ms=60_000.0)
        srv.step()
        assert srv.free_rows == 0 and len(srv._queue) == 1
        assert queued in srv._deadline_at
        assert srv.cancel(queued)
        assert queued not in srv._stream and queued not in srv._deadline_at
        assert srv.cancel(active)
        assert active not in srv._stream and srv.idle
        assert not srv._priority and not srv._deadline_at
        assert not srv.cancel(active)
        rid = srv.submit(PROMPT, 6)
        outs.append([int(t) for t in dict(srv.run())[rid]])
    assert outs[0] == outs[1]
