"""Cross-host metric aggregation: the distributed half of observability —
a copy of `tfde_tpu/observability/aggregate.py`. The push body, the
rollups and `prometheus_text()` are the JAX package's, so a port
worker pushes to a JAX chief and back. The port has no `MetricsServer`
yet (ROADMAP queue 1 item 4): a chief serves `/push` and `/metrics` with
the JAX package's endpoint, or one of its own, over this aggregator.

The fleet becomes visible from one scrape:

- **push path** (`MetricsPusher` / `push_once`): non-chief hosts POST a
  periodic JSON snapshot (`metrics.flatten_snapshot`, so serving stats and
  resilience counters ride along for free) to the chief's metrics endpoint
  at ``/push``. Plain stdlib HTTP — no new dependencies, tolerant of a
  chief that is not up yet (failures are counted, not raised).
- **chief side** (`ClusterAggregator`): stores each host's latest snapshot
  with its arrival time, derives a rolling per-host step-time median from
  the pushed ``train/step`` histogram deltas, and on every rollup exports:

  - ``cluster/hosts_reporting`` / ``cluster/hosts_stale`` gauges,
  - cluster step-time rollups ``cluster/step_time_{min,median,max}_ms``
    (min/median/max of the live hosts' rolling medians),
  - the **straggler detector**: any host whose rolling median exceeds the
    cluster median by `straggler_factor` flips ``cluster/straggler_host``
    (host id, -1 when healthy) and ``cluster/straggler_ratio``, and feeds
    `resilience/health.note_straggler` so the resilience layer sees it;
  - a dead host (no push within `stale_after`) is excluded from rollups,
    counted stale, and reported to `resilience/health.note_stale_host`.

- **exposition**: `prometheus_text()` renders every host's scalar snapshot
  as genuinely *labelled* series (``tfde_train_steps_per_sec{host="1"}``)
  plus per-host liveness (``tfde_cluster_host_up{host="1"}``), which
  `MetricsServer` appends to its `/metrics` body — so one chief scrape
  answers "which host is sick".

Rollups are recomputed on every ingest AND every scrape, so staleness flips
without waiting for a (never-arriving) push from the dead host.
"""

from __future__ import annotations

import collections
import json
import logging
import os
import threading
import time
from typing import Callable, Dict, List, Optional

from tfde_tpu_torch.observability import metrics
from tfde_tpu_torch.observability.exposition import prom_name

log = logging.getLogger(__name__)

#: step-time histogram the per-host medians are derived from
STEP_HIST = "train/step"


def snapshot_payload(registry: Optional[metrics.Registry] = None,
                     host: Optional[int] = None) -> dict:
    """The push body: this process's flattened snapshot plus identity."""
    from tfde_tpu_torch.observability.flightrec import _host_id

    reg = registry or metrics.default_registry()
    return {
        "host": int(_host_id() if host is None else host),
        "pid": os.getpid(),
        "ts": time.time(),
        "metrics": metrics.flatten_snapshot(reg.snapshot()),
    }


def push_once(url: str, registry: Optional[metrics.Registry] = None,
              host: Optional[int] = None, timeout: float = 2.0) -> bool:
    """POST one snapshot to the chief's ``/push``. Returns success; never
    raises — an unreachable chief must not take a worker down with it."""
    import urllib.request

    body = json.dumps(snapshot_payload(registry, host)).encode()
    req = urllib.request.Request(
        url, data=body, headers={"Content-Type": "application/json"},
        method="POST",
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            ok = 200 <= resp.status < 300
            reply = resp.read()
    except Exception as e:
        metrics.counter("cluster/push_errors").incr()
        log.debug("metrics push to %s failed: %s", url, e)
        return False
    if ok:
        _apply_push_reply(reply)
    return ok


def _apply_push_reply(reply: bytes) -> None:
    """The push channel is bidirectional on the cheap: the chief's /push
    response can carry a pending coordinated-profile command, which we
    deliver to this worker's trigger hub (stamped ``coordinated`` so the
    chief-side broadcast sink never re-broadcasts it — no loops)."""
    try:
        payload = json.loads(reply)
    except (ValueError, TypeError):
        return  # pre-JSON chiefs reply b"ok\n" — nothing to deliver
    cmd = payload.get("profile") if isinstance(payload, dict) else None
    if not isinstance(cmd, dict):
        return
    try:
        from tfde_tpu_torch.observability import profiler

        profiler.trigger(
            str(cmd.get("reason") or "coordinated"),
            key=f"coordinated:{cmd.get('id')}",
            span=cmd.get("span"),
            coordinated=True,
        )
    except Exception:
        log.exception("coordinated profile command failed")


class MetricsPusher:
    """Background thread pushing this host's snapshot every `interval`
    seconds (plus once at stop, so the chief sees the final state)."""

    def __init__(self, url: str, interval: float = 5.0,
                 registry: Optional[metrics.Registry] = None,
                 host: Optional[int] = None, timeout: float = 2.0):
        if interval <= 0:
            raise ValueError("interval must be positive")
        self.url = url
        self.interval = float(interval)
        self._reg = registry
        self._host = host
        self._timeout = timeout
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="tfde-metrics-pusher"
        )
        self._thread.start()
        log.info("metrics pusher -> %s every %.1fs", url, self.interval)

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            if push_once(self.url, self._reg, self._host, self._timeout):
                metrics.counter("cluster/pushes").incr()

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)
        # final push: the chief's last view of this host includes everything
        # up to shutdown (e.g. the final step's serving stats)
        push_once(self.url, self._reg, self._host, self._timeout)


class _Host:
    """Chief-side record of one pushing host."""

    def __init__(self, window: int):
        self.flat: Dict[str, float] = {}
        self.last_push = 0.0
        self.pushes = 0
        self.step_samples: collections.deque = collections.deque(maxlen=window)
        self._prev_sum: Optional[float] = None
        self._prev_count: Optional[float] = None

    def ingest(self, flat: Dict[str, float], now: float) -> None:
        self.flat = flat
        self.last_push = now
        self.pushes += 1
        s = flat.get(f"{STEP_HIST}/sum")
        c = flat.get(f"{STEP_HIST}/count")
        if s is None or c is None:
            return
        if self._prev_sum is not None and c > self._prev_count:
            # mean step time over the push interval: recency-aware, unlike
            # the cumulative p50 the histogram itself would report
            self.step_samples.append(
                (s - self._prev_sum) / (c - self._prev_count)
            )
        elif self._prev_sum is None and c > 0:
            self.step_samples.append(s / c)
        self._prev_sum, self._prev_count = s, c

    def median_step(self) -> Optional[float]:
        if not self.step_samples:
            return None
        vals = sorted(self.step_samples)
        n = len(vals)
        mid = n // 2
        return vals[mid] if n % 2 else 0.5 * (vals[mid - 1] + vals[mid])


def _median(vals: List[float]) -> float:
    vals = sorted(vals)
    n = len(vals)
    mid = n // 2
    return vals[mid] if n % 2 else 0.5 * (vals[mid - 1] + vals[mid])


class ClusterAggregator:
    """Chief-side store + rollup engine for pushed host snapshots.

    `include_local` (a host id, usually 0) folds the chief's OWN registry
    into every rollup as a synthetic push, so cluster medians cover the
    chief without it HTTP-pushing to itself.
    """

    def __init__(self,
                 registry: Optional[metrics.Registry] = None,
                 straggler_factor: float = 2.0,
                 stale_after: float = 15.0,
                 window: int = 32,
                 include_local: Optional[int] = None,
                 on_straggler: Optional[Callable[[int, float], None]] = None,
                 on_stale: Optional[Callable[[int, float], None]] = None,
                 coordinate: bool = False,
                 clock: Callable[[], float] = time.monotonic):
        if straggler_factor <= 1.0:
            raise ValueError("straggler_factor must be > 1")
        self._reg = registry or metrics.default_registry()
        self.straggler_factor = float(straggler_factor)
        self.stale_after = float(stale_after)
        self._window = int(window)
        self._include_local = include_local
        self._clock = clock
        self._lock = threading.Lock()
        self._hosts: Dict[int, _Host] = {}
        if on_straggler is None or on_stale is None:
            from tfde_tpu_torch.resilience import health as _health

            on_straggler = on_straggler or _health.note_straggler
            on_stale = on_stale or _health.note_stale_host
        self._on_straggler = on_straggler
        self._on_stale = on_stale
        self._flagged_straggler: Optional[int] = None
        self._known_stale: set = set()
        # coordinated-capture broadcast: one pending command, delivered at
        # most once per host via the /push response channel
        self._profile_cmd: Optional[dict] = None
        self._profile_delivered: set = set()
        self._profile_seq = 0
        if coordinate:
            from tfde_tpu_torch.observability import profiler

            profiler.hub().register("cluster_broadcast", self._broadcast_sink)

    # -- coordinated capture -------------------------------------------------
    def broadcast_profile(self, reason: str,
                          span: Optional[int] = None) -> dict:
        """Queue a coordinated capture command for every pushing host. The
        next /push from each host picks it up (once per host) through the
        push response, so cross-host windows need no new channel."""
        with self._lock:
            self._profile_seq += 1
            cmd = {"id": self._profile_seq, "reason": str(reason)}
            if span is not None:
                cmd["span"] = int(span)
            self._profile_cmd = cmd
            self._profile_delivered = set()
        metrics.counter("cluster/profile_broadcasts").incr()
        log.warning("cluster: broadcasting coordinated profile capture "
                    "#%d (%s) to pushing hosts", cmd["id"], reason)
        return dict(cmd)

    def pending_profile(self, host: int) -> Optional[dict]:
        """The command `host` has not seen yet, marking it delivered —
        called by the /push handler to build its response."""
        with self._lock:
            cmd = self._profile_cmd
            if cmd is None or host in self._profile_delivered:
                return None
            self._profile_delivered.add(int(host))
            return dict(cmd)

    def _broadcast_sink(self, reason: str, span: int, info: dict) -> bool:
        # a command that ARRIVED via the push channel must not fan back
        # out — only locally-originated triggers broadcast
        if info.get("coordinated"):
            return False
        self.broadcast_profile(reason, span)
        return True

    # -- ingest --------------------------------------------------------------
    def ingest(self, payload: dict) -> None:
        """Accept one pushed snapshot ({"host", "metrics", ...})."""
        host = int(payload["host"])
        flat = payload.get("metrics") or {}
        now = self._clock()
        with self._lock:
            h = self._hosts.setdefault(host, _Host(self._window))
            h.ingest({k: float(v) for k, v in flat.items()}, now)
        metrics.counter("cluster/snapshots_received").incr()
        self.rollup()

    def _ingest_local_locked(self, now: float) -> None:
        if self._include_local is None:
            return
        h = self._hosts.setdefault(self._include_local, _Host(self._window))
        h.ingest(metrics.flatten_snapshot(self._reg.snapshot()), now)

    # -- rollups -------------------------------------------------------------
    def rollup(self) -> dict:
        """Recompute cluster gauges from the current host set; returns the
        rollup as plain data (the test/obs_dump surface)."""
        now = self._clock()
        with self._lock:
            self._ingest_local_locked(now)
            hosts = dict(self._hosts)
        live, stale = {}, {}
        for hid, h in hosts.items():
            if now - h.last_push > self.stale_after:
                stale[hid] = now - h.last_push
            else:
                live[hid] = h
        medians = {hid: m for hid, h in live.items()
                   if (m := h.median_step()) is not None}

        g = self._reg.gauge
        g("cluster/hosts_reporting").set(len(live))
        g("cluster/hosts_stale").set(len(stale))
        out = {"hosts_reporting": len(live), "hosts_stale": len(stale),
               "stale_hosts": sorted(stale), "straggler_host": -1,
               "straggler_ratio": 0.0, "host_medians_ms": {}}

        # Edge-detection state (_known_stale / _flagged_straggler below) is
        # mutated under the lock: rollup() runs concurrently from every
        # /push handler thread, and unlocked read-modify-writes here can
        # double-fire callbacks or lose the re-arm. Callbacks themselves
        # fire AFTER release — a slow or re-entrant on_stale must not hold
        # the aggregator's lock. (tools/tfdelint.py lock-discipline rule.)
        fire_stale = []
        with self._lock:
            for hid, age in stale.items():
                if hid not in self._known_stale:
                    self._known_stale.add(hid)
                    fire_stale.append((hid, age))
            self._known_stale &= set(stale)  # re-arm when a host comes back
        for hid, age in fire_stale:
            log.warning("cluster: host %d stale (last push %.1fs ago)",
                        hid, age)
            try:
                self._on_stale(hid, age)
            except Exception:
                log.exception("on_stale callback failed")

        if medians:
            cluster_med = _median(list(medians.values()))
            g("cluster/step_time_min_ms").set(min(medians.values()) * 1e3)
            g("cluster/step_time_median_ms").set(cluster_med * 1e3)
            g("cluster/step_time_max_ms").set(max(medians.values()) * 1e3)
            out["host_medians_ms"] = {
                hid: m * 1e3 for hid, m in medians.items()
            }
            straggler, ratio = -1, 0.0
            if len(medians) >= 2 and cluster_med > 0:
                worst = max(medians, key=medians.get)
                worst_ratio = medians[worst] / cluster_med
                if worst_ratio > self.straggler_factor:
                    straggler, ratio = worst, worst_ratio
            g("cluster/straggler_host").set(straggler)
            g("cluster/straggler_ratio").set(ratio)
            out["straggler_host"], out["straggler_ratio"] = straggler, ratio
            with self._lock:
                fire = (straggler >= 0
                        and straggler != self._flagged_straggler)
                self._flagged_straggler = (straggler if straggler >= 0
                                           else None)
            if fire:
                log.warning(
                    "cluster: host %d straggling (%.1fx the cluster median "
                    "step time)", straggler, ratio,
                )
                try:
                    self._on_straggler(straggler, ratio)
                except Exception:
                    log.exception("on_straggler callback failed")
                try:
                    # ask the trigger hub for capture evidence — on a chief
                    # built with coordinate=True the broadcast sink turns
                    # this into a cross-host window
                    from tfde_tpu_torch.observability import profiler

                    profiler.trigger(
                        "straggler", key=f"straggler:{straggler}",
                        host=straggler, ratio=round(ratio, 2),
                    )
                except Exception:
                    log.exception("straggler profile trigger failed")

        # fleet KV capacity (observability/capacity.py): waste is the
        # allocation-weighted mean — a big idle replica's waste should
        # dominate a small busy one's — and headroom is the plain sum of
        # rows the fleet could still admit
        alloc = waste_weighted = headroom = 0.0
        seen_kv = False
        for h in live.values():
            a = h.flat.get("kv/allocated_bytes")
            if a is None:
                continue
            seen_kv = True
            alloc += a
            waste_weighted += a * h.flat.get("kv/waste_frac", 0.0)
            headroom += h.flat.get("kv/headroom_rows", 0.0)
        if seen_kv:
            waste = waste_weighted / alloc if alloc else 0.0
            g("cluster/kv_waste_frac").set(waste)
            g("cluster/kv_headroom_rows").set(headroom)
            out["kv_waste_frac"] = waste
            out["kv_headroom_rows"] = headroom

        # fleet boot picture (observability/boot.py): how long a joining
        # replica takes to become placeable — the autoscaler's scale-out
        # lead-time signal — as the live hosts' time-to-ready p50/max
        ttrs = [v for h in live.values()
                if (v := h.flat.get("boot/time_to_ready_seconds"))
                is not None]
        if ttrs:
            p50 = _median(ttrs)
            g("cluster/boot_p50_seconds").set(p50)
            g("cluster/boot_max_seconds").set(max(ttrs))
            out["boot_p50_seconds"] = p50
            out["boot_max_seconds"] = max(ttrs)
        return out

    # -- exposition ----------------------------------------------------------
    def prometheus_text(self, prefix: str = "tfde_") -> str:
        """Per-host labelled series appended to the chief's /metrics body:
        every pushed scalar as ``<name>{host="<id>"}`` plus liveness/age."""
        now = self._clock()
        with self._lock:
            hosts = {hid: (dict(h.flat), h.last_push)
                     for hid, h in self._hosts.items()}
        lines = []
        for hid in sorted(hosts):
            flat, last_push = hosts[hid]
            age = now - last_push
            up = 0 if age > self.stale_after else 1
            lines.append(f'{prefix}cluster_host_up{{host="{hid}"}} {up}')
            lines.append(
                f'{prefix}cluster_host_age_seconds{{host="{hid}"}} {age:.3f}'
            )
            for name in sorted(flat):
                lines.append(
                    f'{prom_name(name, prefix)}{{host="{hid}"}} '
                    f'{float(flat[name])!r}'
                )
        return "\n".join(lines) + ("\n" if lines else "")

    def host_metrics(self, prefixes: tuple) -> Dict[int, Dict[str, float]]:
        """{host: {name: value}} for every pushed scalar whose name starts
        with one of `prefixes` — the filtered read the router's mem/compile
        snapshot block uses (the full flat dict can be thousands of
        series; nobody should json-dump it per poll)."""
        with self._lock:
            return {
                hid: {name: float(v) for name, v in h.flat.items()
                      if name.startswith(prefixes)}
                for hid, h in self._hosts.items()
            }

    def hosts(self) -> Dict[int, dict]:
        """{host: {"age": s, "pushes": n, "median_step_ms": ms|None}} —
        the obs_dump/debugging surface."""
        now = self._clock()
        with self._lock:
            return {
                hid: {
                    "age": now - h.last_push,
                    "pushes": h.pushes,
                    "median_step_ms": (
                        m * 1e3 if (m := h.median_step()) is not None else None
                    ),
                }
                for hid, h in self._hosts.items()
            }


# -- distributed request traces ----------------------------------------------
def fetch_trace(url: str, trace_id: str, timeout: float = 5.0) -> list:
    """GET one replica's /trace/<id> slice; [] on any transport failure
    (a SIGKILL'd replica has no ring left to contribute — the router's
    own events still tell its side of the story)."""
    import urllib.request

    target = f"{url.rstrip('/')}/trace/{trace_id}"
    try:
        with urllib.request.urlopen(target, timeout=timeout) as resp:
            payload = json.loads(resp.read())
        return list(payload.get("events") or [])
    except Exception as e:  # noqa: BLE001 — dead peers are expected here
        log.debug("trace fetch from %s failed: %s", target, e)
        return []


def collect_trace(trace_id: str, urls, local_events=None,
                  timeout: float = 5.0) -> dict:
    """Chief-side stitcher: pull one trace id's events from every replica
    endpoint, merge them with the caller's local ring slice onto the
    shared wall-clock axis (trace.stitch), and report which processes
    contributed — the payload behind the Router's GET /trace/<id>."""
    from tfde_tpu_torch.observability import trace as _trace

    lists = [fetch_trace(u, trace_id, timeout=timeout) for u in urls]
    if local_events is not None:
        lists.append(list(local_events))
    events = _trace.stitch(lists)
    procs = sorted({str(e["proc"]) for e in events if e.get("proc")})
    return {"trace": trace_id, "events": events, "procs": procs}
