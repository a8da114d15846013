"""The port's boot and readiness ledger (tfde_tpu_torch/observability/
boot.py) against the JAX package: twins of the twelve tests of
`tests/test_boot.py` on an injected clock and compile probe — phases
tile from birth and sum to time-to-ready, the state machine walks the
lifecycle, epochs reset, the compile attribution splits at the ready
edge, restore bandwidth and its proportional attribution, the serving
marks skip warm-up — each driven through BOTH packages' ledgers with the
same edges, whose snapshots and gauges must be equal. The goodput
cross-check holds the port ledger against the JAX goodput ledger fed the
same simulated events (the port has no goodput ledger yet). The port's
default compile probe reads (0, 0.0): it has no recompile sentinel."""

import time

import pytest

from tfde_tpu.observability import boot as jboot
from tfde_tpu.observability import goodput as jgoodput
from tfde_tpu.observability import metrics as jmetrics
from tfde_tpu_torch.observability import boot, metrics


class _Clock:
    """Deterministic monotonic clock for phase arithmetic."""

    def __init__(self, t: float = 100.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def tick(self, dt: float) -> float:
        self.t += dt
        return self.t


def _pair(clk, birth=None, probe=None):
    """(port ledger, JAX ledger, port registry, JAX registry) on one
    clock and probe."""
    reg, jreg = metrics.Registry(), jmetrics.Registry()
    kw = dict(birth=clk.t if birth is None else birth, clock=clk,
              compile_probe=probe or (lambda: (0, 0.0)))
    return (boot.BootLedger(registry=reg, **kw),
            jboot.BootLedger(registry=jreg, **kw), reg, jreg)


def _both(pair, fn):
    fn(pair[0])
    fn(pair[1])


def _same(pair):
    """Equal snapshots and equal registries; returns the port snapshot."""
    led, jled, reg, jreg = pair
    snap = led.snapshot()
    assert snap == jled.snapshot()
    assert reg.snapshot() == jreg.snapshot()
    return snap


def test_phases_tile_and_first_backdates_to_birth():
    clk = _Clock(100.0)
    pair = _pair(clk, birth=90.0)
    led, _, reg, _ = pair
    for phase, dt in (("init", 2.0), ("bootstrap", 3.0), ("restore", 1.5),
                      ("compile", 4.0), ("warmup", 0.5)):
        _both(pair, lambda x: x.begin(phase))
        clk.tick(dt)
    _both(pair, lambda x: x.ready())
    ph = led.phase_seconds()
    assert ph == pytest.approx({"init": 12.0, "bootstrap": 3.0,
                                "restore": 1.5, "compile": 4.0,
                                "warmup": 0.5})
    assert led.time_to_ready() == pytest.approx(sum(ph.values()))
    assert reg.get("boot/init_seconds").value == pytest.approx(12.0)
    assert reg.get("boot/compile_wall_seconds").value == pytest.approx(4.0)
    assert reg.get("boot/time_to_ready_seconds").value == pytest.approx(21.0)
    _same(pair)


def test_phase_decomposition_sums_to_ttft_within_tolerance():
    clk = _Clock(50.0)
    pair = _pair(clk)
    _both(pair, lambda x: x.begin("init"))
    clk.tick(4.0)
    _both(pair, lambda x: x.begin("compile"))
    clk.tick(5.5)
    _both(pair, lambda x: x.ready())
    clk.tick(0.3)
    _both(pair, lambda x: x.note_first_token())
    snap = _same(pair)
    ttft_s = snap["ttft_from_birth_ms"] / 1e3
    assert sum(snap["phases"].values()) == pytest.approx(9.5)
    assert abs(ttft_s - sum(snap["phases"].values())) <= 0.05 * ttft_s


def test_unknown_phase_rejected():
    led = _pair(_Clock())[0]
    with pytest.raises(ValueError):
        led.begin("reticulating")
    with pytest.raises(ValueError):
        led.note_phase("reticulating", 1.0)
    assert boot.PHASES == jboot.PHASES and boot.STATES == jboot.STATES
    assert boot.PLACEABLE_STATES == jboot.PLACEABLE_STATES


def test_ledger_monotonic_and_states_walk_lifecycle():
    clk = _Clock()
    pair = _pair(clk)
    led = pair[0]
    assert led.state == "starting"
    states = []
    for phase, state in (("restore", "restoring"), ("compile", "compiling"),
                         ("warmup", "warming")):
        _both(pair, lambda x: x.begin(phase))
        assert led.state == pair[1].state == state
        clk.tick(1.0)
        states.append(led.phase_seconds()[phase])
        clk.tick(1.0)
        assert led.phase_seconds()[phase] >= states[-1]
    assert led.time_to_ready() is None
    _both(pair, lambda x: x.ready())
    assert led.state == "ready"
    ttr = led.time_to_ready()
    clk.tick(10.0)
    _both(pair, lambda x: x.ready())
    assert led.time_to_ready() == pytest.approx(ttr)
    _both(pair, lambda x: x.draining())
    assert led.state == "draining"
    snap = _same(pair)
    assert snap["age_s"] >= ttr
    assert sum(snap["phases"].values()) == pytest.approx(ttr)


def test_new_epoch_resets_everything():
    clk = _Clock()
    pair = _pair(clk)
    led, _, reg, _ = pair
    _both(pair, lambda x: x.begin("init"))
    clk.tick(2.0)
    _both(pair, lambda x: x.ready())
    _both(pair, lambda x: x.note_first_token())
    _both(pair, lambda x: x.note_restore_leaf("params", 1000, 1.0))
    assert led.new_epoch(cause="topology_change") == 1
    pair[1].new_epoch(cause="topology_change")
    assert led.epoch == 1 and led.state == "starting"
    assert led.birth == pytest.approx(clk.t)
    assert led.phase_seconds() == {}
    assert led.time_to_ready() is None
    snap = _same(pair)
    assert snap["ttft_from_birth_ms"] is None
    assert snap["restore"]["bytes"] == 0
    assert reg.get("boot/epochs").value == 1
    # the fresh epoch measures its rejoin with the same instrument
    with pair[0].phase("bootstrap"), pair[1].phase("bootstrap"):
        clk.tick(3.0)
    _both(pair, lambda x: x.ready())
    assert led.time_to_ready() == pytest.approx(3.0)
    _same(pair)


def test_compile_attribution_splits_at_ready_edge():
    probe = {"v": (0, 0.0)}
    clk = _Clock()
    pair = _pair(clk, probe=lambda: probe["v"])
    led, _, reg, _ = pair
    _both(pair, lambda x: x.begin("compile"))
    probe["v"] = (5, 2.5)
    clk.tick(1.0)
    attr = led.compile_attribution()
    assert attr == pair[1].compile_attribution()
    assert attr["boot"] == {"count": 5, "seconds": 2.5}
    assert attr["steady"] == {"count": 0, "seconds": 0.0}
    _both(pair, lambda x: x.ready())
    probe["v"] = (7, 3.1)
    attr = led.compile_attribution()
    assert attr["boot"] == {"count": 5, "seconds": 2.5}
    assert attr["steady"]["count"] == 2
    assert attr["steady"]["seconds"] == pytest.approx(0.6)
    assert reg.get("boot/compile_count").value == 5
    assert reg.get("boot/compile_seconds").value == pytest.approx(2.5)
    snap = _same(pair)
    assert snap["compile"]["boot_count"] == 5
    assert snap["compile"]["steady_count"] == 2


def test_restore_bandwidth_hand_computed():
    pair = _pair(_Clock())
    _both(pair, lambda x: x.note_restore_leaf("params", 6_000_000, 2.0))
    _both(pair, lambda x: x.note_restore_leaf("opt_state", 2_000_000, 2.0))
    snap = _same(pair)["restore"]
    assert snap["bytes"] == 8_000_000
    assert snap["bandwidth_bps"] == pytest.approx(2_000_000.0)
    assert pair[2].get("boot/restore_bandwidth_bps").value == \
        pytest.approx(2_000_000.0)


def test_module_note_restore_targets_only_booting_ledgers():
    clk = _Clock()
    booting, jbooting, _, _ = _pair(clk)
    served, jserved, _, _ = _pair(clk)
    for b, s in ((booting, served), (jbooting, jserved)):
        b.begin("init")
        s.ready()
    boot.note_restore({"params": 3_000_000, "opt": 1_000_000}, 2.0)
    jboot.note_restore({"params": 3_000_000, "opt": 1_000_000}, 2.0)
    snap = booting.snapshot()
    assert snap == jbooting.snapshot()
    assert snap["restore"]["leaves"]["params"]["seconds"] == pytest.approx(
        1.5)
    assert snap["restore"]["leaves"]["opt"]["seconds"] == pytest.approx(0.5)
    assert snap["phases"]["restore"] == pytest.approx(2.0)
    assert served.snapshot()["restore"]["bytes"] == 0


def test_first_marks_ignore_warmup_and_are_idempotent():
    """The module-level marks (the batcher's hooks) skip a ledger still
    booting and land once on a ready one; a port batcher's submit and
    first token drive them."""
    import numpy as np

    from tfde_tpu_torch.inference.server import ContinuousBatcher
    from tfde_tpu_torch.models.gpt import gpt_tiny_test

    clk = _Clock()
    pair = _pair(clk)
    led = pair[0]
    _both(pair, lambda x: x.begin("warmup"))
    boot.note_first_admit()
    boot.note_first_token()
    jboot.note_first_admit()
    jboot.note_first_token()
    assert led.snapshot()["first_admit_s"] is None
    assert led.snapshot()["ttft_from_birth_ms"] is None
    clk.tick(2.0)
    _both(pair, lambda x: x.ready())
    clk.tick(0.25)
    srv = ContinuousBatcher(gpt_tiny_test(device="cpu"), batch_size=1,
                            max_len=16, device="cpu")
    srv.submit(np.asarray([1, 2, 3]), 2)     # boot.note_first_admit
    srv.step()                               # boot.note_first_token
    jboot.note_first_admit()
    jboot.note_first_token()
    snap = _same(pair)
    assert snap["first_admit_s"] == pytest.approx(2.25)
    assert snap["ttft_from_birth_ms"] == pytest.approx(2250.0)
    clk.tick(60.0)
    boot.note_first_token()
    assert led.snapshot()["ttft_from_birth_ms"] == pytest.approx(2250.0)


def test_boot_ledger_cross_checks_against_goodput_buckets():
    """An elastic rejoin simulated into the port ledger and, with the
    same events, into the JAX goodput ledger: the bootstrap phase matches
    goodput's rebootstrap share of restart_loss and the boot compile
    attribution its compile bucket, within 5%."""
    jreg = jmetrics.Registry()
    gp = jgoodput.GoodputLedger(registry=jreg)
    probe = {"v": (0, 0.0)}
    clk = _Clock()
    led = boot.BootLedger(birth=clk.t, registry=metrics.Registry(),
                          clock=clk, compile_probe=lambda: probe["v"])
    led.new_epoch(cause="topology_change")
    with led.phase("bootstrap"):
        clk.tick(2.0)
    jreg.counter("resilience/rebootstrap_seconds").incr(2.0)
    with led.phase("compile"):
        probe["v"] = (4, 1.2)
        jreg.counter("compile/serve_decode/seconds_total").incr(1.2)
        clk.tick(1.3)
    led.ready()
    rep = gp.report(wall_seconds=10.0)
    ph = led.phase_seconds()
    assert abs(rep["seconds"]["restart_loss"] - ph["bootstrap"]) \
        <= 0.05 * ph["bootstrap"]
    boot_compile = led.compile_attribution()["boot"]["seconds"]
    assert abs(rep["seconds"]["compile"] - boot_compile) \
        <= 0.05 * max(boot_compile, 1e-9)
    assert sum(rep["fractions"].values()) == pytest.approx(1.0)


def test_process_birth_is_before_now_and_sane():
    birth = boot.process_birth_monotonic()
    now = time.monotonic()
    assert birth <= now
    assert now - birth < 86400.0
    assert abs(birth - jboot.process_birth_monotonic()) < 1.0


def test_default_ledger_uses_process_birth():
    """A default ledger is born at the process's birth, and the port's
    default compile probe (no recompile sentinel) reads (0, 0.0)."""
    led = boot.BootLedger(registry=metrics.Registry())
    led.begin("init")
    led.ready()
    assert led.time_to_ready() > 0.0
    assert led.phase_seconds()["init"] == pytest.approx(led.time_to_ready())
    assert boot._default_compile_probe() == (0, 0.0)
    assert led.compile_attribution() == {
        "boot": {"count": 0, "seconds": 0.0},
        "steady": {"count": 0, "seconds": 0.0}}
