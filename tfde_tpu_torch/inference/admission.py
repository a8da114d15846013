"""Admission control for the serving tiers: caps, priorities, shedding —
a copy of `tfde_tpu/inference/admission.py` (host code, no device).

Without it a traffic spike just grows the batcher's queue unboundedly
and every request's TTFT degrades together. The pieces:

- `AdmissionController`: queue-depth and queued-token-budget caps
  enforced at `submit()` time, the KV-headroom floor against the
  batcher's `kv_stats()`, plus a drain-rate EWMA (fed from the decode
  loop) that turns "how overloaded are we" into a `Retry-After`
  estimate — seconds until the backlog ahead of a new request would
  clear at the current token rate.
- Priority classes `interactive` > `batch` > `best_effort`: the
  batcher's queue drains highest-priority-first (FIFO within a class),
  and unlabeled traffic is `interactive` so existing clients see no
  behavior change.
- `QueueFull`: the typed rejection `submit()` raises when a cap is hit,
  carrying queue depth + the drain estimate (+ the KV snapshot when the
  memory gate was consulted); `as_json()` is the 429 body that
  `inference/router.ReplicaServer` answers with `Retry-After`.
- `force_overload(seconds)`: the fault-injection lever — while armed,
  every controller rejects as if saturated, making the overload story
  drillable in one process without generating 2x-capacity load. The
  lever is this module's own state, apart from the JAX package's.

Caps default OFF (0 = unlimited, from ``TFDE_ADMIT_MAX_QUEUE``,
``TFDE_ADMIT_MAX_QUEUED_TOKENS``, ``TFDE_ADMIT_TTFT_DEADLINE_MS`` and
``TFDE_ADMIT_KV_HEADROOM``, the JAX package's names and meanings):
admission control is an opt-in guardrail, and a single-tenant batcher
must behave exactly as before this module existed. Unlike the JAX
readers, an unreadable value raises (`knobs.env_count`,
`knobs.env_float`).
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from tfde_tpu_torch import knobs

#: priority classes, highest first — index order IS drain order
PRIORITIES = ("interactive", "batch", "best_effort")
#: name -> rank (0 = most important); brownout sheds highest rank first
PRIORITY_RANK = {p: i for i, p in enumerate(PRIORITIES)}
#: unlabeled traffic is interactive: pre-existing clients never get
#: brownout-shed or drained behind labeled batch work
DEFAULT_PRIORITY = "interactive"

#: HTTP header carrying the class between router and replica (the body
#: field "priority" is equivalent; the header survives primed hand-offs
#: whose body is the K/V payload)
PRIORITY_HEADER = "X-Tfde-Priority"

#: Retry-After clamp: never tell a client "come back in 0s" (thundering
#: herd) or "come back in an hour" (a drain estimate that far out is
#: noise, not a forecast)
MIN_RETRY_AFTER_S = 0.5
MAX_RETRY_AFTER_S = 60.0


def validate_priority(priority: Optional[str]) -> str:
    """Normalize a wire-supplied priority; raises ValueError on unknown
    spellings (a typo'd class silently becoming best_effort would be a
    production incident, not a convenience)."""
    if priority is None or priority == "":
        return DEFAULT_PRIORITY
    p = str(priority).strip().lower()
    if p not in PRIORITY_RANK:
        raise ValueError(
            f"unknown priority {priority!r}; expected one of {PRIORITIES}"
        )
    return p


class QueueFull(RuntimeError):
    """Typed submit() rejection: the batcher's queue is at a cap.

    Carries enough state for a well-formed 429: current queue depth,
    queued token backlog, and the drain-rate-derived retry estimate.
    Subclasses RuntimeError, so callers that predate admission control
    (and catch RuntimeError into a 400/500) stay correct; overload-aware
    callers catch QueueFull FIRST and map it to 429 + Retry-After.
    """

    def __init__(self, reason: str, queue_depth: int, queued_tokens: int,
                 retry_after_s: float, kv: Optional[dict] = None):
        self.reason = str(reason)
        self.queue_depth = int(queue_depth)
        self.queued_tokens = int(queued_tokens)
        self.retry_after_s = float(retry_after_s)
        #: KV-capacity snapshot (the batcher's kv_stats()) when the
        #: memory gate was consulted — tells a rejected client WHICH
        #: resource is scarce, not just that one is
        self.kv = dict(kv) if kv else None
        super().__init__(
            f"queue full ({self.reason}): depth={self.queue_depth}, "
            f"queued_tokens={self.queued_tokens}, retry in "
            f"~{self.retry_after_s:.1f}s"
        )

    def as_json(self) -> dict:
        """The 429 response body schema (the JAX tests/test_router.py's)."""
        out = {
            "error": "queue full",
            "reason": self.reason,
            "queue_depth": self.queue_depth,
            "queued_tokens": self.queued_tokens,
            "retry_after_s": round(self.retry_after_s, 3),
        }
        if self.kv is not None:
            out["kv"] = self.kv
        return out


# -- forced overload (fault injection) ----------------------------------------
_force_lock = threading.Lock()
_forced_until = 0.0


def force_overload(seconds: float) -> None:
    """Arm the overload lever: for `seconds` every AdmissionController
    rejects as if saturated (the JAX resilience/faults.OverloadFault's
    hook; the port has no fault injector yet).
    Idempotent; overlapping arms extend to the latest deadline."""
    global _forced_until
    until = time.monotonic() + float(seconds)
    with _force_lock:
        _forced_until = max(_forced_until, until)


def clear_overload() -> None:
    """Disarm a forced overload early (test teardown)."""
    global _forced_until
    with _force_lock:
        _forced_until = 0.0


def overload_active() -> bool:
    with _force_lock:
        return time.monotonic() < _forced_until


class AdmissionController:
    """Per-batcher admission policy: caps, deadline default, drain rate.

    Thread-safety: `check`/`note_drain`/`retry_after_s` are called under
    the batcher's external lock (the JAX `ReplicaServer.lock`), so the
    controller itself carries no lock; the module-level forced-overload
    state has its own.

    cap semantics: 0 or None = unlimited (the default — admission control
    off). `max_queue` bounds QUEUED requests (active rows don't count:
    they are already paid for); `max_queued_tokens` bounds the queued
    output-token backlog, the unit the drain rate is measured in.
    """

    def __init__(self, max_queue: Optional[int] = None,
                 max_queued_tokens: Optional[int] = None,
                 ttft_deadline_ms: Optional[float] = None,
                 min_headroom_rows: Optional[int] = None):
        if max_queue is None:
            max_queue = knobs.env_count("TFDE_ADMIT_MAX_QUEUE")
        if max_queued_tokens is None:
            max_queued_tokens = knobs.env_count(
                "TFDE_ADMIT_MAX_QUEUED_TOKENS")
        if ttft_deadline_ms is None:
            ttft_deadline_ms = knobs.env_float(
                "TFDE_ADMIT_TTFT_DEADLINE_MS", 0.0)
        if min_headroom_rows is None:
            min_headroom_rows = knobs.env_count("TFDE_ADMIT_KV_HEADROOM")
        self.max_queue = int(max_queue or 0)
        self.max_queued_tokens = int(max_queued_tokens or 0)
        #: memory gate: reject while the capacity model's headroom_rows
        #: is below this floor (0 = off) — admission fails on *memory*
        #: before the queue-depth proxy ever collapses
        self.min_headroom_rows = int(min_headroom_rows or 0)
        #: default TTFT deadline applied to every request that does not
        #: bring its own (0 = no deadline shedding)
        self.ttft_deadline_ms = float(ttft_deadline_ms or 0.0)
        # drain-rate EWMA, tokens/second, fed by the decode loop
        self._drain_tps = 0.0

    @property
    def enabled(self) -> bool:
        return bool(self.max_queue or self.max_queued_tokens
                    or self.min_headroom_rows)

    # -- drain rate ---------------------------------------------------------
    def note_drain(self, n_tokens: int, dt_s: float,
                   alpha: float = 0.2) -> None:
        """Fold one decode round's token output into the rate estimate."""
        if n_tokens <= 0 or dt_s <= 0:
            return
        rate = n_tokens / dt_s
        self._drain_tps = (rate if self._drain_tps == 0.0
                           else (1 - alpha) * self._drain_tps + alpha * rate)

    @property
    def drain_rate_tps(self) -> float:
        return self._drain_tps

    def retry_after_s(self, queued_tokens: int) -> float:
        """Seconds until the current backlog clears at the measured drain
        rate — the Retry-After a rejected client is told. Before the
        first decode round there is no rate; answer the clamp floor
        (an idle server's backlog clears almost immediately)."""
        if self._drain_tps <= 0.0:
            return MIN_RETRY_AFTER_S
        est = queued_tokens / self._drain_tps
        return min(max(est, MIN_RETRY_AFTER_S), MAX_RETRY_AFTER_S)

    # -- the gate -----------------------------------------------------------
    def would_reject(self, queue_depth: int, queued_tokens: int,
                     budget: int = 1,
                     headroom_rows: Optional[int] = None) -> Optional[str]:
        """The reason a request with `budget` new tokens would be
        rejected right now, or None when it would be admitted — the
        /load snapshot's `saturated` signal and `check`'s core.
        `headroom_rows` is the capacity model's current estimate (None =
        no ledger wired, memory gate silently inert)."""
        if overload_active():
            return "forced_overload"
        if self.max_queue and queue_depth >= self.max_queue:
            return "queue_depth"
        if self.max_queued_tokens and (
                queued_tokens + budget > self.max_queued_tokens):
            return "queued_tokens"
        if (self.min_headroom_rows and headroom_rows is not None
                and headroom_rows < self.min_headroom_rows):
            return "kv_headroom"
        return None

    def check(self, queue_depth: int, queued_tokens: int,
              budget: int, headroom_rows: Optional[int] = None,
              kv: Optional[dict] = None,
              drain_tokens: Optional[int] = None) -> None:
        """Admit or raise QueueFull. Called by the batcher before
        enqueue, under its external lock. `kv` (the batcher's capacity
        snapshot) rides on the rejection; `drain_tokens` is the
        outstanding decode backlog, the Retry-After basis when the
        memory gate — not queue depth — is binding (headroom frees up
        as ACTIVE rows finish, which the queued backlog alone can't
        estimate: the queue may well be empty)."""
        reason = self.would_reject(queue_depth, queued_tokens, budget,
                                   headroom_rows=headroom_rows)
        if reason is not None:
            backlog = queued_tokens + budget
            if reason == "kv_headroom" and drain_tokens:
                backlog = max(backlog, int(drain_tokens))
            raise QueueFull(reason, queue_depth, queued_tokens,
                            self.retry_after_s(backlog), kv=kv)
