"""Cluster-health sinks — the part of `tfde_tpu/resilience/health.py`
that the serving front door and the chief-side aggregator call:

- ``note_straggler(host, ratio)``: the aggregator's straggler detector
  flagged a host (``resilience/stragglers_detected`` counter,
  ``resilience/straggler_host`` and ``resilience/straggler_ratio``
  gauges, a ``straggler`` flight event);
- ``note_replica_down(replica, reason)``: the router took a serving
  replica out of rotation (``resilience/replicas_lost`` counter,
  ``resilience/last_replica_lost`` gauge, a ``replica_lost`` flight
  event);
- ``note_stale_host(host, age_seconds)``: a host stopped pushing metric
  snapshots (``resilience/stale_hosts_detected`` counter, a
  ``stale_host`` flight event).

The JAX `note_stale_host` also makes a host silent past the elastic
detect threshold a topology suspect (`resilience/elastic.note_peer_lost`);
the port has no elastic layer yet, so that step is left out. The
`Heartbeat` watchdog, `StallError` and the stall escalation wait for the
port's supervisor.
"""

from __future__ import annotations

from tfde_tpu_torch.observability import counters, flightrec, metrics


def note_straggler(host: int, ratio: float) -> None:
    """Chief-side sink for the cluster straggler detector
    (observability/aggregate.py): a host's rolling step-time median
    exceeds the cluster median by the configured factor."""
    counters.incr("resilience/stragglers_detected")
    metrics.gauge("resilience/straggler_host").set(host)
    metrics.gauge("resilience/straggler_ratio").set(ratio)
    flightrec.record("straggler", host=int(host), ratio=float(ratio))


def note_replica_down(replica: int, reason: str) -> None:
    """Router-side sink for a lost SERVING replica (inference/router.py):
    a connection failure or stale metric pushes took it out of
    rotation."""
    counters.incr("resilience/replicas_lost")
    metrics.gauge("resilience/last_replica_lost").set(replica)
    flightrec.record("replica_lost", replica=int(replica),
                     reason=str(reason))


def note_stale_host(host: int, age_seconds: float) -> None:
    """Chief-side sink for the dead-host detector: a host stopped pushing
    snapshots. Liveness itself is per-host (the scheduler's job); this is
    the fleet-view breadcrumb."""
    counters.incr("resilience/stale_hosts_detected")
    flightrec.record("stale_host", host=int(host),
                     age_seconds=round(float(age_seconds), 3))
