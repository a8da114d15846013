"""Boot & readiness observability: the cold-start ledger for fast-boot
replicas — a copy of `tfde_tpu/observability/boot.py`. The default
compile probe reads (0, 0.0): the port has no recompile sentinel yet.

ROADMAP item 2 (fast-boot replicas, autoscaled fleet) is blocked on an
unmeasured interval: a joining replica pays a full checkpoint restore
plus a compile storm before serving token one, and nothing decomposed
that interval or told the router when the joiner was safe to place
traffic on. This module is that instrument, three legs:

- **BootLedger.** Decomposes a replica's life from process birth to
  first served token into tiled phases — ``init`` (process start to
  first instrumented edge), ``bootstrap`` (distributed init), ``restore``
  (checkpoint read, with per-top-level-leaf bytes + seconds feeding
  ``boot/restore_bandwidth_bps``), ``compile`` (the pad-ladder
  enumeration), ``warmup`` (prefix-trie / cache priming) — and marks the
  first admitted request and first served token. Phases are published
  eagerly as ``boot/{phase}_seconds`` gauges (the compile phase's wall
  is ``boot/compile_wall_seconds``; ``boot/compile_{count,seconds}`` are
  the backend-compile attribution from the recompile sentinel, split
  boot vs steady-state at the ready edge), plus
  ``boot/time_to_ready_seconds`` and ``boot/ttft_from_birth_ms``, with a
  flight-recorder breadcrumb per phase edge. ``new_epoch()`` re-arms the
  ledger for the elastic path: a supervisor re-bootstrap measures its
  rejoin with the identical instrument, cross-checkable against
  goodput's init/compile buckets.

- **Readiness states.** The ledger owns a tiny state machine
  (``starting -> restoring -> compiling -> warming -> ready ->
  draining``) derived from the open phase. `ReplicaServer` surfaces it
  in ``/healthz`` and ``/load``; the Router places traffic only on
  ``ready`` replicas (``TFDE_BOOT_READY_REQUIRE``) and gives a booting
  replica ``TFDE_BOOT_READY_GRACE_S`` before push staleness may declare
  it lost — `Router._mark_down` accounts a never-ready death to
  ``router/replicas_never_ready``, not ``router/replicas_lost``.

- **Fleet rollup.** Replicas push their ``boot/*`` gauges like any
  other metric; `aggregate.py` rolls up ``cluster/boot_{p50,max}_seconds``
  — the control signals the autoscaler will consume — and
  ``tools/obs_dump.py --boot`` renders the per-replica waterfall.

Deployment contract: one replica per process (the cluster shape), so
the per-process gauges and the process-global ``current()`` ledger are
unambiguous. In-process multi-replica tests construct per-instance
ledgers; their gauges share the registry and last-writer-wins, which is
fine for the readiness machine (per-instance state) and irrelevant for
the fleet rollup (gauges are host-labelled by the push path).
"""

from __future__ import annotations

import os
import threading
import time
import weakref
from typing import Callable, Dict, Optional

from tfde_tpu_torch import knobs
from tfde_tpu_torch.observability import flightrec, metrics

#: boot phases in canonical order; `begin()` tiles them (each phase
#: starts where the previous ended; the first is backdated to birth)
PHASES = ("init", "bootstrap", "restore", "compile", "warmup")

#: readiness states in lifecycle order
STATES = ("starting", "restoring", "compiling", "warming", "ready",
          "draining")

#: which state an OPEN phase maps to (init/bootstrap are both pre-restore
#: process bring-up; the split matters for the waterfall, not the router)
_PHASE_STATE = {"init": "starting", "bootstrap": "starting",
                "restore": "restoring", "compile": "compiling",
                "warmup": "warming"}

#: states the router may place traffic on ("unknown" is a replica the
#: router has not snapshotted yet — fail open for legacy robustness)
PLACEABLE_STATES = ("ready", "unknown")

#: fallback birth anchor: this module's import time
_IMPORT_MONOTONIC = time.monotonic()

#: every live ledger, so the serving path's module-level first-admit /
#: first-token marks reach whichever ledger(s) this process is driving
_LEDGERS: "weakref.WeakSet[BootLedger]" = weakref.WeakSet()

_CURRENT: Optional["BootLedger"] = None
_CURRENT_LOCK = threading.Lock()


def ready_require() -> bool:
    """Router-side gate: place traffic only on `ready` replicas."""
    return knobs.env_flag("TFDE_BOOT_READY_REQUIRE", True)


def ready_grace_s() -> float:
    """Seconds a never-ready replica may stay silent/not-ready before
    push staleness is allowed to declare it down."""
    return knobs.env_float("TFDE_BOOT_READY_GRACE_S", 120.0)


def process_birth_monotonic() -> float:
    """This process's birth on the `time.monotonic` clock, from
    /proc/self/stat start time vs /proc/uptime (Linux). Falls back to
    this module's import time — late, but strictly after-birth, so the
    ledger's time-to-ready underestimates rather than invents."""
    try:
        with open("/proc/self/stat") as f:
            stat = f.read()
        # field 22 (1-based) is starttime in clock ticks; fields after
        # the parenthesised comm (which may contain spaces) are stable
        after = stat.rsplit(")", 1)[1].split()
        start_ticks = float(after[19])
        hertz = float(os.sysconf("SC_CLK_TCK"))
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - start_ticks / hertz
        if age < 0:
            raise ValueError("negative process age")
        return time.monotonic() - age
    except Exception:
        return _IMPORT_MONOTONIC


def _default_compile_probe():
    """(count, seconds) of backend compiles this process has paid. The
    JAX package reads its recompile sentinel here; the port has no
    recompile sentinel yet (ROADMAP queue 1 item 4), so this is (0, 0.0),
    what JAX's probe returns when its sentinel is not installed: the
    attribution degrades to zeros instead of lying."""
    return 0, 0.0


class BootLedger:
    """One boot epoch's phase ledger + readiness state (module
    docstring). Thread-safe: HTTP handler threads read `snapshot()`
    while the booting code advances phases."""

    def __init__(self, birth: Optional[float] = None,
                 registry: Optional[metrics.Registry] = None,
                 clock: Callable[[], float] = time.monotonic,
                 compile_probe: Optional[Callable] = None):
        self._lock = threading.Lock()
        self._clock = clock
        self._reg = registry or metrics.default_registry()
        self._probe = compile_probe or _default_compile_probe
        with self._lock:
            self._birth = (float(birth) if birth is not None
                           else process_birth_monotonic())
            self._epoch = 0
            self._phases: Dict[str, float] = {}
            self._open: Optional[tuple] = None   # (name, start)
            self._state = "starting"
            self._ready_at: Optional[float] = None
            self._first_admit_at: Optional[float] = None
            self._first_token_at: Optional[float] = None
            self._restore_leaves: Dict[str, dict] = {}
            self._compile_base = self._probe()
            self._compile_at_ready: Optional[tuple] = None
        _LEDGERS.add(self)

    # -- phase edges ---------------------------------------------------------
    def begin(self, phase: str) -> None:
        """Open `phase`, closing any open phase at the same instant so
        phases tile. The epoch's first phase is backdated to birth: the
        un-instrumented interval before the first instrumented edge IS
        process init."""
        if phase not in PHASES:
            raise ValueError(f"unknown boot phase {phase!r} "
                             f"(one of {PHASES})")
        now = self._clock()
        with self._lock:
            self._close_open_locked(now)
            start = now if self._phases or self._open else self._birth
            self._open = (phase, start)
            if self._state != "ready":   # a ready replica priming more
                self._state = _PHASE_STATE[phase]
        flightrec.record("boot_phase", phase=phase, edge="begin",
                         epoch=self._epoch)

    def end(self) -> None:
        """Close the open phase (no-op when none is open)."""
        now = self._clock()
        with self._lock:
            closed = self._close_open_locked(now)
        if closed is not None:
            name, secs = closed
            self._publish_phase(name, self._phases[name])
            flightrec.record("boot_phase", phase=name, edge="end",
                             seconds=round(secs, 4), epoch=self._epoch)

    def phase(self, name: str):
        """Context manager: ``with ledger.phase("restore"): ...``"""
        ledger = self

        class _Phase:
            def __enter__(self):
                ledger.begin(name)
                return ledger

            def __exit__(self, *exc):
                ledger.end()
                return False

        return _Phase()

    def note_phase(self, phase: str, seconds: float) -> None:
        """Credit an externally timed interval to `phase` (the
        checkpoint manager times its own restore call; the supervisor
        times the elastic re-bootstrap)."""
        if phase not in PHASES:
            raise ValueError(f"unknown boot phase {phase!r}")
        secs = max(0.0, float(seconds))
        with self._lock:
            self._phases[phase] = self._phases.get(phase, 0.0) + secs
            total = self._phases[phase]
        self._publish_phase(phase, total)
        flightrec.record("boot_phase", phase=phase, edge="note",
                         seconds=round(secs, 4), epoch=self._epoch)

    def _close_open_locked(self, now: float):
        if self._open is None:
            return None
        name, start = self._open
        secs = max(0.0, now - start)
        self._phases[name] = self._phases.get(name, 0.0) + secs
        self._open = None
        return name, secs

    def _publish_phase(self, name: str, total: float) -> None:
        # the compile PHASE is wall-clock around the ladder enumeration;
        # boot/compile_seconds is reserved for the backend-compile
        # attribution published at the ready edge
        gname = ("boot/compile_wall_seconds" if name == "compile"
                 else f"boot/{name}_seconds")
        self._reg.gauge(gname).set(total)

    # -- restore accounting --------------------------------------------------
    def note_restore_leaf(self, name: str, nbytes: int,
                          seconds: float) -> None:
        """Record one top-level checkpoint leaf's restore cost. Seconds
        may be the shared call's wall attributed proportionally by the
        caller; the bandwidth gauge divides summed bytes by summed
        seconds either way."""
        with self._lock:
            self._restore_leaves[str(name)] = {
                "bytes": int(nbytes), "seconds": max(0.0, float(seconds)),
            }
            tot_b = sum(e["bytes"] for e in self._restore_leaves.values())
            tot_s = sum(e["seconds"] for e in self._restore_leaves.values())
        if tot_s > 0:
            self._reg.gauge("boot/restore_bandwidth_bps").set(tot_b / tot_s)

    # -- serving edges -------------------------------------------------------
    def note_first_admit(self) -> None:
        """First request admitted this epoch (idempotent)."""
        now = self._clock()
        with self._lock:
            if self._first_admit_at is not None:
                return
            self._first_admit_at = now
        self._reg.gauge("boot/first_admit_seconds").set(now - self._birth)
        flightrec.record("boot_phase", phase="first_admit", edge="mark",
                         epoch=self._epoch)

    def note_first_token(self) -> None:
        """First served token this epoch (idempotent):
        ``boot/ttft_from_birth_ms`` — the whole cold-start answer."""
        now = self._clock()
        with self._lock:
            if self._first_token_at is not None:
                return
            self._first_token_at = now
            ms = (now - self._birth) * 1e3
        self._reg.gauge("boot/ttft_from_birth_ms").set(ms)
        flightrec.record("boot_phase", phase="first_token", edge="mark",
                         ttft_from_birth_ms=round(ms, 2), epoch=self._epoch)

    # -- lifecycle -----------------------------------------------------------
    def ready(self) -> None:
        """Boot is over: close any open phase, snapshot the compile
        probe (the boot-vs-steady attribution split point), publish the
        epoch's gauges, flip the state (idempotent)."""
        now = self._clock()
        with self._lock:
            if self._state == "ready":
                return
            self._close_open_locked(now)   # folds into _phases below
            self._state = "ready"
            self._ready_at = now
            self._compile_at_ready = self._probe()
            ttr = now - self._birth
            boot_count = self._compile_at_ready[0] - self._compile_base[0]
            boot_secs = self._compile_at_ready[1] - self._compile_base[1]
            phases = dict(self._phases)
        for name, total in phases.items():
            self._publish_phase(name, total)
        g = self._reg.gauge
        g("boot/time_to_ready_seconds").set(ttr)
        g("boot/compile_count").set(max(0, boot_count))
        g("boot/compile_seconds").set(max(0.0, boot_secs))
        g("boot/epoch").set(self._epoch)
        flightrec.record("boot_ready", epoch=self._epoch,
                         time_to_ready_s=round(ttr, 3),
                         compile_count=max(0, boot_count),
                         compile_seconds=round(max(0.0, boot_secs), 3),
                         phases={k: round(v, 3) for k, v in phases.items()})

    def draining(self) -> None:
        with self._lock:
            self._state = "draining"
        flightrec.record("boot_phase", phase="draining", edge="mark",
                         epoch=self._epoch)

    def new_epoch(self, cause: str = "") -> int:
        """Re-arm for a fresh boot (elastic rejoin): phases, marks and
        the compile base reset; birth becomes now. Returns the epoch."""
        now = self._clock()
        with self._lock:
            self._epoch += 1
            epoch = self._epoch
            self._birth = now
            self._phases = {}
            self._open = None
            self._state = "starting"
            self._ready_at = None
            self._first_admit_at = None
            self._first_token_at = None
            self._restore_leaves = {}
            self._compile_base = self._probe()
            self._compile_at_ready = None
        self._reg.counter("boot/epochs").incr()
        self._reg.gauge("boot/epoch").set(epoch)
        flightrec.record("boot_epoch", epoch=epoch, cause=str(cause))
        return epoch

    # -- reads ---------------------------------------------------------------
    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    @property
    def epoch(self) -> int:
        with self._lock:
            return self._epoch

    @property
    def birth(self) -> float:
        with self._lock:
            return self._birth

    def phase_seconds(self) -> Dict[str, float]:
        """Closed phase durations, the open phase counted up to now."""
        now = self._clock()
        with self._lock:
            out = dict(self._phases)
            if self._open is not None:
                name, start = self._open
                out[name] = out.get(name, 0.0) + max(0.0, now - start)
        return out

    def time_to_ready(self) -> Optional[float]:
        with self._lock:
            if self._ready_at is None:
                return None
            return self._ready_at - self._birth

    def compile_attribution(self) -> dict:
        """Backend-compile split at the ready edge: compiles paid before
        ready are boot cost (the pad-ladder enumeration the fast-boot
        work must cache away); after, steady-state recompiles."""
        now_c, now_s = self._probe()
        with self._lock:
            base_c, base_s = self._compile_base
            at_ready = self._compile_at_ready
        if at_ready is None:   # still booting: everything so far is boot
            return {"boot": {"count": max(0, now_c - base_c),
                             "seconds": max(0.0, now_s - base_s)},
                    "steady": {"count": 0, "seconds": 0.0}}
        return {"boot": {"count": max(0, at_ready[0] - base_c),
                         "seconds": max(0.0, at_ready[1] - base_s)},
                "steady": {"count": max(0, now_c - at_ready[0]),
                           "seconds": max(0.0, now_s - at_ready[1])}}

    def snapshot(self) -> dict:
        """JSON-able ledger view (the /load and /replicas `boot` block)."""
        now = self._clock()
        phases = self.phase_seconds()
        attr = self.compile_attribution()
        with self._lock:
            birth = self._birth
            ready_at = self._ready_at
            first_admit = self._first_admit_at
            first_token = self._first_token_at
            leaves = {k: dict(v) for k, v in self._restore_leaves.items()}
            state, epoch = self._state, self._epoch
        tot_b = sum(e["bytes"] for e in leaves.values())
        tot_s = sum(e["seconds"] for e in leaves.values())
        return {
            "state": state,
            "epoch": epoch,
            "age_s": round(now - birth, 3),
            "phases": {k: round(v, 4) for k, v in phases.items()},
            "time_to_ready_s": (round(ready_at - birth, 3)
                                if ready_at is not None else None),
            "first_admit_s": (round(first_admit - birth, 3)
                              if first_admit is not None else None),
            "ttft_from_birth_ms": (round((first_token - birth) * 1e3, 2)
                                   if first_token is not None else None),
            "restore": {
                "bytes": tot_b,
                "seconds": round(tot_s, 4),
                "bandwidth_bps": (tot_b / tot_s if tot_s > 0 else None),
                "leaves": leaves,
            },
            "compile": {
                "boot_count": attr["boot"]["count"],
                "boot_seconds": round(attr["boot"]["seconds"], 4),
                "steady_count": attr["steady"]["count"],
                "steady_seconds": round(attr["steady"]["seconds"], 4),
            },
        }


# -- process-global ledger + serving-path marks ------------------------------
def current() -> BootLedger:
    """The process-global ledger (training path, serve children). Lazily
    created; its birth is the real process birth when /proc allows."""
    global _CURRENT
    with _CURRENT_LOCK:
        if _CURRENT is None:
            _CURRENT = BootLedger()
        return _CURRENT


def note_first_admit() -> None:
    """Serving-path hook (`server.py` enqueue): mark every READY
    ledger's first admitted request — cheap after the first call per
    ledger. Gated on readiness so a replica's own warm-up submits
    (compile/warmup phases drive the same batcher path) never pass for
    client traffic; the mark lands on the first post-ready request."""
    for led in list(_LEDGERS):
        if led.state == "ready":
            led.note_first_admit()


def note_first_token() -> None:
    """Serving-path hook (`server.py` TTFT observation): mark every
    READY ledger's first served token (same warm-up gate as
    `note_first_admit`) — `boot/ttft_from_birth_ms` means a token a
    CLIENT saw, not a warm-up token the replica fed itself."""
    for led in list(_LEDGERS):
        if led.state == "ready":
            led.note_first_token()


def note_restore(leaves: Dict[str, int], seconds: float) -> None:
    """Checkpoint-manager hook: credit a restore's per-top-level-leaf
    bytes (seconds attributed proportionally by bytes) to every ledger
    still booting — a steady-state restore is not boot cost."""
    total = sum(max(0, int(b)) for b in leaves.values())
    secs = max(0.0, float(seconds))
    targets = [led for led in list(_LEDGERS) if led.state != "ready"]
    for led in targets:
        for name, nbytes in leaves.items():
            frac = (int(nbytes) / total) if total else 0.0
            led.note_restore_leaf(name, int(nbytes), secs * frac)
        led.note_phase("restore", secs)
