"""Multi-replica serving front door: HTTP/SSE routing above the batcher
— the port of `tfde_tpu/inference/router.py`.

- `ReplicaServer` puts one batcher (`ContinuousBatcher` or
  `SpeculativeContinuousBatcher`) behind a stdlib HTTP endpoint: POST
  /generate streams tokens as Server-Sent Events as the step-loop thread
  produces them (request handlers only `submit()` and poll
  `take_progress()` under `lock`), POST /prime and /generate_primed for
  the prefill/decode role split, GET /load (the router's placement
  signal), /healthz (the boot ledger's readiness state), /trace/<id>
  (this process's trace ring for one request) and POST /profile (a
  bounded decode-round capture, observability/profiler.py). A capped
  batcher's `QueueFull` answers 429 with an integer Retry-After and
  `QueueFull.as_json()`; a request shed at dequeue after its stream
  opened gets an in-band `deadline_shed` event; a consumer that hangs
  up cancels its request. `push_url` pushes the serving gauges to a
  chief's /push (observability/aggregate.py).
- `Router` is the front door: POST /v1/generate places each session on
  the live, ready replica with the fewest outstanding tokens (its own
  ledger, plus an attached `ClusterAggregator`'s push staleness as a
  down signal), relays the replica's SSE stream, re-routes a session
  that has streamed no token yet when its replica dies and reports a
  retriable error after; primes prompts of `prefill_min_tokens` or more
  on the prefill tier and hands the K/V to a decode replica; sheds by
  priority under SLO burn (brownout) and rejects fast when every replica
  is saturated; POST /drain and /profile, GET /replicas and
  /trace/<id>.
- `request_generate` is the blocking client.

The wire is the JAX package's — routes, status codes, the
``X-Tfde-Trace`` and ``X-Tfde-Priority`` headers, the SSE events and
their keys, the /load and /replicas bodies and the primed payload — so a
client, router or replica of either package works with the other's.

The primed payload (`primed_to_json`, `primed_from_json`): the prompt
and the first token as JSON ints, and each K/V plane as {"shape",
"dtype", "data": base64 of the raw bytes}, keyed by the JAX
cache-collection leaf path (`prefix_cache.leaf_name`:
``decoder/block_<layer>/attn/cached_key`` and so on). The one mapping
between those paths and the port's plane names (`KVCache.planes()`:
`(layer, 'k' | 'v' | 'k_scale' | 'v_scale')`) is `LEAF_OF` below, read
off the JAX `init_cache` trees (dense and int8). The dtype names are
numpy's ("float32", "int8"); bfloat16 travels as its raw 16-bit words
under "bfloat16", the JAX package's `ml_dtypes` name, with no
`ml_dtypes` here. An unknown dtype or leaf path raises.
"""

from __future__ import annotations

import base64
import collections
import json
import logging
import math
import re
import socket
import sys
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch

from tfde_tpu_torch import knobs
from tfde_tpu_torch.inference import admission as _admission
from tfde_tpu_torch.observability import boot as _boot
from tfde_tpu_torch.observability import flightrec, metrics
from tfde_tpu_torch.observability import profiler as profiler_lib
from tfde_tpu_torch.observability import trace as _trace
from tfde_tpu_torch.observability.aggregate import (
    MetricsPusher,
    collect_trace,
)
from tfde_tpu_torch.observability.slo import SLOTracker
from tfde_tpu_torch.resilience.health import note_replica_down

log = logging.getLogger(__name__)

#: connection-level failures that mean "the replica is gone", as opposed
#: to an HTTP error meaning "the request was bad"
_DEAD = (urllib.error.URLError, ConnectionError, socket.timeout,
         TimeoutError, EOFError)


# -- primed-request wire format ----------------------------------------------
#: the port's plane -> the JAX attention module's cache leaf
LEAF_OF = {"k": "cached_key", "v": "cached_value",
           "k_scale": "cached_key_scale", "v_scale": "cached_value_scale"}
_PLANE_OF = {leaf: plane for plane, leaf in LEAF_OF.items()}
_LEAF_PATH = re.compile(r"decoder/block_(\d+)/attn/(\w+)")

#: wire dtype name <-> torch dtype
_DTYPES = {"float32": torch.float32, "float16": torch.float16,
           "bfloat16": torch.bfloat16, "int8": torch.int8}
_WIRE = {t: name for name, t in _DTYPES.items()}


def leaf_name(name: tuple) -> str:
    """The JAX leaf path of the port's plane `(layer, plane)`."""
    layer, plane = name
    if plane not in LEAF_OF:
        raise ValueError(f"unknown K/V plane {plane!r}")
    return f"decoder/block_{int(layer)}/attn/{LEAF_OF[plane]}"


def plane_name(leaf: str) -> tuple:
    """The port's plane `(layer, plane)` of a JAX leaf path."""
    m = _LEAF_PATH.fullmatch(leaf)
    if m is None or m.group(2) not in _PLANE_OF:
        raise ValueError(f"unknown K/V leaf {leaf!r}: expected "
                         f"decoder/block_<layer>/attn/<"
                         f"{'|'.join(_PLANE_OF)}>")
    return int(m.group(1)), _PLANE_OF[m.group(2)]


def _encode(t: torch.Tensor) -> dict:
    if t.dtype not in _WIRE:
        raise ValueError(f"no wire dtype for {t.dtype}")
    t = t.detach().cpu().contiguous()
    # numpy has no bfloat16: its bytes travel as 16-bit words
    raw = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()
    return {"shape": list(t.shape), "dtype": _WIRE[t.dtype],
            "data": base64.b64encode(raw.tobytes()).decode("ascii")}


def _decode(entry: dict) -> torch.Tensor:
    dtype = _DTYPES.get(entry["dtype"])
    if dtype is None:
        raise ValueError(f"unknown wire dtype {entry['dtype']!r}; expected "
                         f"one of {sorted(_DTYPES)}")
    raw = bytearray(base64.b64decode(entry["data"]))
    return torch.frombuffer(raw, dtype=dtype).reshape(entry["shape"])


def primed_to_json(primed) -> dict:
    """PrimedRequest -> JSON-safe dict (K/V as base64 raw bytes)."""
    return {
        "prompt": np.asarray(primed.prompt).tolist(),
        "first_token": int(primed.first_token),
        "max_new_tokens": int(primed.max_new_tokens),
        "kv": {leaf_name(name): _encode(t) for name, t in primed.kv.items()},
    }


def primed_from_json(payload: dict):
    """JSON dict (from either package) -> PrimedRequest with host tensors
    keyed by the port's plane names."""
    from tfde_tpu_torch.inference.server import PrimedRequest

    return PrimedRequest(
        prompt=np.asarray(payload["prompt"], np.int64),
        first_token=int(payload["first_token"]),
        max_new_tokens=int(payload["max_new_tokens"]),
        kv={plane_name(leaf): _decode(e)
            for leaf, e in payload["kv"].items()},
    )


# -- SSE helpers -------------------------------------------------------------
def _sse_write(wfile, obj: dict) -> None:
    wfile.write(b"data: " + json.dumps(obj).encode() + b"\n\n")
    wfile.flush()


def sse_events(fp):
    """Yield parsed `data:` events from a byte stream until EOF."""
    for raw in fp:
        line = raw.strip()
        if line.startswith(b"data: "):
            yield json.loads(line[6:])


def _post_json(url: str, payload: dict, timeout: float, headers=None):
    hdrs = {"Content-Type": "application/json"}
    if headers:
        hdrs.update(headers)
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(), headers=hdrs,
        method="POST",
    )
    return urllib.request.urlopen(req, timeout=timeout)


class _FleetHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer tuned for a serving tier: socketserver's
    default listen backlog of 5 silently drops SYNs under a request
    burst — the client's kernel retransmits ~1s later, which shows up
    as a phantom 1s TTFT tail (or a reset) that no server-side metric
    explains. Overload policy belongs to the admission layer (429 +
    Retry-After), so accept the burst and let it decide."""

    daemon_threads = True
    request_queue_size = 128

    def handle_error(self, request, client_address):
        # a client that hung up first (a router's /load poll past its
        # timeout, a consumer gone mid-stream) is no fault of the server's
        if not isinstance(sys.exc_info()[1],
                          (BrokenPipeError, ConnectionResetError)):
            super().handle_error(request, client_address)


class _FairLock:
    """A re-entrant lock granted in arrival order. The step loop releases
    the replica's lock after a step and takes it again at once: under an
    ordinary lock it wins that race against the handler threads it woke
    (they still have to be scheduled), so on the card a request's tokens
    reached its stream only when the replica went idle. Here a release
    hands the lock straight to the oldest waiter."""

    def __init__(self):
        self._mutex = threading.Lock()
        self._waiters: collections.deque = collections.deque()
        self._owner: Optional[int] = None
        self._depth = 0

    def acquire(self) -> bool:
        me = threading.get_ident()
        with self._mutex:
            if self._owner == me:
                self._depth += 1
                return True
            if self._owner is None and not self._waiters:
                self._owner, self._depth = me, 1
                return True
            turn = threading.Event()
            self._waiters.append((me, turn))
        turn.wait()   # `release` made this thread the owner
        return True

    def release(self) -> None:
        with self._mutex:
            if self._owner != threading.get_ident():
                raise RuntimeError("release of a lock this thread does "
                                   "not hold")
            self._depth -= 1
            if self._depth:
                return
            if self._waiters:
                self._owner, turn = self._waiters.popleft()
                self._depth = 1
                turn.set()
            else:
                self._owner = None

    __enter__ = acquire

    def __exit__(self, *exc) -> None:
        self.release()


# -- replica-side server -----------------------------------------------------
class ReplicaServer:
    """One batcher replica behind HTTP/SSE (see the module docstring).

    The batcher is driven by an internal step-loop thread; HTTP handlers
    hold `lock` only to submit and to drain `take_progress`, so a long
    decode scan never blocks accepting work for the next one. `lock` is
    granted in arrival order (`_FairLock`): a handler that waits during
    a step gets it before the next step.
    `replica_id` doubles as the metrics `host` label when `push_url`
    (the chief/router's /push endpoint) is given — keep it equal to the
    replica's index in the router's replica list.
    """

    def __init__(self, batcher, port: int = 0, host: str = "127.0.0.1",
                 replica_id: int = 0, push_url: Optional[str] = None,
                 push_interval: float = 2.0,
                 model_dir: Optional[str] = None,
                 poll_interval: float = 0.002,
                 boot_ledger=None):
        self.batcher = batcher
        batcher.enable_progress()
        self.replica_id = int(replica_id)
        self.lock = _FairLock()
        self._poll = float(poll_interval)
        self._stop = threading.Event()
        # readiness: an externally driven BootLedger (a cold-booting
        # replica advances its phases and calls ready() itself); without
        # one the replica is ready the moment start() returns — the
        # conventional in-process construction has no boot to measure
        self._boot_external = boot_ledger is not None
        self.boot = (boot_ledger if boot_ledger is not None
                     else _boot.BootLedger())
        if model_dir is not None:
            flightrec.arm(model_dir)
            _trace.arm(model_dir)
        # usage metering JSONL (TFDE_USAGE_LOG=on) anchors to the same
        # model_dir as the flight ring and trace dumps
        batcher.arm_usage_log(model_dir)
        # label this process's trace events (a lone replica per process
        # in the cluster deployment — the stitched waterfall's row name)
        _trace.set_process(f"replica{self.replica_id}")
        # serving-side bounded capture: a RoundWindowProfiler over decode
        # rounds, armable by POST /profile or any hub trigger (SLO burn,
        # recompile storm, coordinated broadcast)
        self.profiler = profiler_lib.RoundWindowProfiler(
            model_dir,
            artifacts=(profiler_lib.ProfileArtifacts(model_dir)
                       if model_dir is not None else None),
            device=batcher.device,
        )
        batcher.attach_profiler(self.profiler)
        self._hub_sink = f"replica{self.replica_id}_round_window"
        profiler_lib.hub().register(self._hub_sink, self.profiler.trigger_sink)
        srv = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.0"  # close-delimited SSE streams

            def log_message(self, *a):  # quiet; metrics carry the signal
                pass

            def do_GET(self):
                if self.path == "/healthz":
                    # liveness stays a 200 (the process answers); the
                    # READINESS state rides the body so pollers and the
                    # router can tell "up" from "safe to place on"
                    state = srv.state
                    srv._send_json(self, 200, {
                        "ok": state == "ready",
                        "state": state,
                        "replica": srv.replica_id,
                    })
                elif self.path == "/load":
                    srv._send_json(self, 200, srv.load())
                elif self.path.startswith("/trace/"):
                    # this process's ring slice for one trace id — the
                    # chief collector stitches these across replicas
                    tid = self.path[len("/trace/"):]
                    srv._send_json(self, 200, {
                        "proc": _trace.process(), "trace": tid,
                        "events": _trace.events(tid),
                    })
                else:
                    self.send_error(404)

            def do_POST(self):
                length = int(self.headers.get("Content-Length", 0))
                try:
                    body = json.loads(self.rfile.read(length) or b"{}")
                except json.JSONDecodeError:
                    srv._send_json(self, 400, {"error": "bad json"})
                    return
                try:
                    if self.path == "/generate":
                        srv._handle_generate(self, body, primed=False)
                    elif self.path == "/generate_primed":
                        srv._handle_generate(self, body, primed=True)
                    elif self.path == "/prime":
                        srv._handle_prime(self, body)
                    elif self.path == "/profile":
                        srv._handle_profile(self, body)
                    else:
                        self.send_error(404)
                except _admission.QueueFull as e:
                    # typed overload rejection — MUST precede the
                    # RuntimeError clause below or it degrades to a 400
                    # that tells the client to fix a request that was
                    # fine. Retry-After is the drain-rate estimate,
                    # integer-seconds per the HTTP spec (the precise
                    # float rides the JSON body).
                    metrics.default_registry().counter(
                        "serving/rejected_429").incr()
                    flightrec.record("admission_reject",
                                     replica=srv.replica_id,
                                     reason=e.reason,
                                     queue_depth=e.queue_depth,
                                     retry_after_s=e.retry_after_s)
                    srv._send_json(
                        self, 429, e.as_json(),
                        headers={"Retry-After":
                                 str(max(1, math.ceil(e.retry_after_s)))},
                    )
                except (ValueError, RuntimeError) as e:
                    srv._send_json(self, 400, {"error": str(e)})

        self._httpd = _FleetHTTPServer((host, port), Handler)
        self.port = self._httpd.server_address[1]
        self.url = f"http://{host}:{self.port}"
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name=f"tfde-replica-{replica_id}-http",
        )
        self._loop_thread = threading.Thread(
            target=self._loop, daemon=True,
            name=f"tfde-replica-{replica_id}-step",
        )
        self._pusher = None
        if push_url is not None:
            self._pusher = MetricsPusher(
                push_url, interval=push_interval, host=self.replica_id,
            )

    def start(self) -> "ReplicaServer":
        self._http_thread.start()
        self._loop_thread.start()
        if not self._boot_external:
            # no external boot ledger: the batcher was built (and warmed)
            # before construction, so the replica is ready now
            self.boot.ready()
        log.info("replica %d serving on %s (state %s)",
                 self.replica_id, self.url, self.state)
        return self

    @property
    def state(self) -> str:
        """Readiness state surfaced on /healthz and /load: the boot
        ledger's machine until ready, `draining` once close() begins."""
        return self.boot.state

    @property
    def loop_alive(self) -> bool:
        """Whether the step-loop thread runs: an exception in `step()`
        ends it (nothing catches it), and the replica's requests then
        wait until their timeouts."""
        return self._loop_thread.is_alive()

    def close(self) -> None:
        self.boot.draining()
        self._stop.set()
        # the step loop ends before anything else goes, so no step runs
        # on a batcher whose caches its owner frees after close()
        if self._loop_thread.is_alive():
            self._loop_thread.join()
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._pusher is not None:
            self._pusher.close()
        profiler_lib.hub().unregister(self._hub_sink)
        self.profiler.close()
        _trace.dump("replica_close")

    def _handle_profile(self, handler, body: dict) -> None:
        """POST /profile {"span": N?, "reason": str?} — arm a bounded
        decode-round capture on this replica. 409 when one is already
        armed/active or the replica has no local model_dir to trace to."""
        span = body.get("span")
        reason = str(body.get("reason") or "operator")
        armed = self.profiler.arm(
            span=int(span) if span is not None else None, reason=reason,
        )
        self._send_json(handler, 200 if armed else 409, {
            "replica": self.replica_id, "armed": armed, "reason": reason,
        })

    def load(self) -> dict:
        # the batcher's contract is "single-threaded under the external
        # ReplicaServer.lock"; reading its queue while the step loop
        # mutates it is the exact race tfdelint's guarded_attrs audit
        # exists to flag
        with self.lock:
            b = self.batcher
            depth = len(b._queue)
            queued_tokens = b.queued_tokens
            kv = b.kv_stats()
            reason = b.admission.would_reject(
                depth, queued_tokens,
                headroom_rows=kv.get("headroom_rows"))
            # Retry-After basis: the queued backlog — unless the MEMORY
            # gate is what binds, where headroom frees as ACTIVE rows
            # finish, so the outstanding decode backlog is the honest
            # drain estimate (the queue may well be empty)
            backlog = queued_tokens
            if reason == "kv_headroom":
                backlog = max(backlog, b.outstanding_tokens)
            return {
                "replica": self.replica_id,
                "role": b.role,
                "state": self.state,
                "boot": self.boot.snapshot(),
                "outstanding_tokens": b.outstanding_tokens,
                "queue_depth": depth,
                "queue_depths": b._queue.depths(),
                "queued_tokens": queued_tokens,
                "free_rows": b.free_rows,
                "drain_rate_tps": b.admission.drain_rate_tps,
                "retry_after_s": b.admission.retry_after_s(backlog),
                "saturated": reason is not None,
                "kv": kv,
            }

    # -- internals ----------------------------------------------------------
    def _loop(self) -> None:
        while not self._stop.is_set():
            with self.lock:
                idle = self.batcher.idle
                if not idle:
                    self.batcher.step()
            if idle:
                time.sleep(self._poll)

    @staticmethod
    def _send_json(handler, code: int, obj: dict, headers=None) -> None:
        body = json.dumps(obj).encode()
        handler.send_response(code)
        handler.send_header("Content-Type", "application/json")
        handler.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            handler.send_header(k, v)
        handler.end_headers()
        handler.wfile.write(body)

    def _handle_prime(self, handler, body: dict) -> None:
        tid = handler.headers.get(_trace.HEADER)
        with self.lock:
            primed = self.batcher.prime(
                body["prompt"], int(body["max_new_tokens"]), trace=tid
            )
        self._send_json(handler, 200, primed_to_json(primed))

    def _handle_generate(self, handler, body: dict, primed: bool) -> None:
        tid = handler.headers.get(_trace.HEADER)
        # the header wins over the body field: a primed hand-off's body
        # is the K/V payload, so the class can only ride the header there
        pr = _admission.validate_priority(
            handler.headers.get(_admission.PRIORITY_HEADER)
            or body.get("priority"))
        dl = body.get("ttft_deadline_ms")
        dl = float(dl) if dl is not None else None
        t_req = time.perf_counter()
        with self.lock:
            if primed:
                rid = self.batcher.submit_primed(
                    primed_from_json(body), trace=tid,
                    priority=pr, ttft_deadline_ms=dl)
            else:
                rid = self.batcher.submit(
                    body["prompt"], int(body["max_new_tokens"]), trace=tid,
                    priority=pr, ttft_deadline_ms=dl,
                )
        try:
            handler.send_response(200)
            handler.send_header("Content-Type", "text/event-stream")
            if tid:
                handler.send_header(_trace.HEADER, tid)
            handler.end_headers()
            first = {"rid": rid, "replica": self.replica_id}
            if tid:
                first["trace"] = tid
            _sse_write(handler.wfile, first)
            sent = 0
            while True:
                with self.lock:
                    toks, done = self.batcher.take_progress(rid)
                    shed = done and self.batcher.was_shed(rid)
                for t in toks:
                    _sse_write(handler.wfile, {"token": int(t)})
                    sent += 1
                if shed:
                    # deadline-shed at dequeue: the SSE headers already
                    # went out when we accepted the submit, so the 429
                    # moment has passed — report the shed in-band as a
                    # retriable error instead of a silent empty `done`
                    with self.lock:
                        ra = self.batcher.admission.retry_after_s(
                            self.batcher.queued_tokens)
                    _sse_write(handler.wfile,
                               {"error": "deadline_shed", "shed": True,
                                "retriable": True,
                                "retry_after_s": round(ra, 3)})
                    return
                if done:
                    _sse_write(handler.wfile, {"done": True, "n": sent})
                    if tid is not None and _trace.active():
                        # the replica-side bracket: submit -> last SSE
                        # byte flushed (decode AND relay)
                        _trace.event("serve/stream_out", trace=tid,
                                     rid=rid, tokens=sent,
                                     dur=time.perf_counter() - t_req)
                    return
                time.sleep(self._poll)
        except (BrokenPipeError, ConnectionResetError):
            # the consumer is gone (router timeout / client disconnect):
            # without the cancel the request would decode to completion
            # on abandoned work and its progress entry would leak forever
            with self.lock:
                self.batcher.cancel(rid)


# -- router ------------------------------------------------------------------
class _Replica:
    __slots__ = ("url", "idx", "up", "outstanding", "served", "drained",
                 "state", "ready_seen", "first_seen")

    def __init__(self, url: str, idx: int):
        self.url = url.rstrip("/")
        self.idx = idx
        self.up = True
        self.drained = False
        self.outstanding = 0   # router-side in-flight token estimate
        self.served = 0
        # readiness (observability/boot.py): last /load-reported state
        # ("unknown" until the first snapshot — fail open), whether this
        # replica has EVER reported ready (distinguishes a lost replica
        # from one that never finished booting), and when the router
        # first saw it (the boot-grace anchor)
        self.state = "unknown"
        self.ready_seen = False
        self.first_seen = time.monotonic()


class Router:
    """Least-outstanding-tokens front door over replica endpoints (see
    the module docstring).

    replicas: decode-capable replica base URLs; index order must match
    each `ReplicaServer.replica_id` so the chief aggregator's
    host-labelled gauges line up with the routing table.
    prefill_replicas: optional prefill-role tier for the role split;
    prompts of at least `prefill_min_tokens` are primed there first.
    aggregator: a `ClusterAggregator` receiving replica pushes — adds
    push-staleness (host-up flip) as a down signal on top of the
    router's own connection-failure detection.
    slo: an `SLOTracker` (one is built from the TFDE_SLO_* environment
    when omitted) fed the CLIENT-observed TTFT/TPOT of every routed
    session — queueing, placement, re-routes and the primed hand-off
    included; its gauges ride /metrics and its summary the /replicas
    table.

    Every /v1/generate session gets a trace id (X-Tfde-Trace — the
    incoming header is honored so callers can bring their own),
    propagated to the replicas and returned to the client in the
    response header, the SSE `meta` event, and the final payload. The
    id is cheap to mint; actual event RECORDING stays off unless the
    trace ring is enabled (TFDE_TRACE). GET /trace/<id> answers the
    stitched cross-process waterfall.
    """

    def __init__(self, replicas, prefill_replicas=(), port: int = 0,
                 host: str = "127.0.0.1", aggregator=None,
                 model_dir: Optional[str] = None,
                 prefill_min_tokens: int = 0,
                 request_timeout: float = 120.0,
                 slo: Optional[SLOTracker] = None,
                 brownout_burn: Optional[float] = None,
                 brownout_burn_batch: Optional[float] = None):
        if not replicas:
            raise ValueError("need at least one replica URL")
        self._reps = [_Replica(u, i) for i, u in enumerate(replicas)]
        self._pre = [_Replica(u, i) for i, u in enumerate(prefill_replicas)]
        self._agg = aggregator
        self._pmin = int(prefill_min_tokens)
        self._timeout = float(request_timeout)
        self._lock = threading.Lock()
        self._reg = metrics.default_registry()
        self._slo = slo if slo is not None else SLOTracker()
        # brownout: fast-window TTFT burn past `brownout_burn` sheds
        # best_effort; past `brownout_burn_batch` sheds batch too.
        # interactive is never brownout-shed — past that point the
        # admission caps are the backstop.
        self._brownout_burn = float(
            brownout_burn if brownout_burn is not None
            else knobs.env_float("TFDE_BROWNOUT_BURN", 8.0))
        self._brownout_burn_batch = float(
            brownout_burn_batch if brownout_burn_batch is not None
            else knobs.env_float("TFDE_BROWNOUT_BURN_BATCH", 16.0))
        self._brownout_level = 0   # 0 off, 1 shed best_effort, 2 + batch
        # /load snapshot cache: saturation is polled per request but the
        # GETs go out at most once per TTL — overload is exactly when a
        # per-request fan-out would make things worse
        self._loads: dict = {}
        self._loads_at = 0.0
        self._load_ttl = 0.25
        # trace id -> replica idx currently relaying it; read by
        # _mark_down so a replica_down flight breadcrumb names the
        # in-flight traces it stranded
        self._inflight: dict = {}
        if model_dir is not None:
            flightrec.arm(model_dir)
            _trace.arm(model_dir)
        _trace.set_process("router")
        router = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.0"

            def log_message(self, *a):
                pass

            def do_GET(self):
                if self.path == "/healthz":
                    body = b"ok\n"
                    self.send_response(200)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif self.path == "/replicas":
                    ReplicaServer._send_json(
                        self, 200,
                        {"replicas": router.table(),
                         "slo": router.slo.summary(),
                         "mem": router.mem_table(),
                         "kv": router.kv_table(),
                         "boot": router.boot_table()},
                    )
                elif self.path.startswith("/trace/"):
                    tid = self.path[len("/trace/"):]
                    ReplicaServer._send_json(self, 200,
                                             router.trace(tid))
                else:
                    self.send_error(404)

            def do_POST(self):
                length = int(self.headers.get("Content-Length", 0))
                try:
                    body = json.loads(self.rfile.read(length) or b"{}")
                except json.JSONDecodeError:
                    ReplicaServer._send_json(self, 400,
                                             {"error": "bad json"})
                    return
                if self.path == "/v1/generate":
                    router._serve_generate(self, body)
                elif self.path == "/drain":
                    try:
                        idx = int(body["replica"])
                        tier = str(body.get("tier", "decode"))
                        if tier not in ("decode", "prefill"):
                            raise ValueError(f"unknown tier {tier!r}")
                    except (KeyError, TypeError, ValueError) as e:
                        ReplicaServer._send_json(
                            self, 400,
                            {"error": f"need integer 'replica' "
                                      f"(+ optional tier): {e}"},
                        )
                        return
                    if router.drain(idx, tier):
                        ReplicaServer._send_json(
                            self, 200, {"drained": idx, "tier": tier}
                        )
                    else:
                        ReplicaServer._send_json(
                            self, 404,
                            {"error": f"unknown {tier} replica {idx}"},
                        )
                elif self.path == "/profile":
                    ReplicaServer._send_json(
                        self, 200, router.profile_all(body))
                else:
                    self.send_error(404)

        self._httpd = _FleetHTTPServer((host, port), Handler)
        self.port = self._httpd.server_address[1]
        self.url = f"http://{host}:{self.port}"
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="tfde-router-http",
        )

    def start(self) -> "Router":
        self._http_thread.start()
        log.info("router serving on %s over %d replica(s)",
                 self.url, len(self._reps))
        return self

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        _trace.dump("router_close")

    @property
    def slo(self) -> SLOTracker:
        return self._slo

    def profile_all(self, body: dict) -> dict:
        """POST /profile fan-out: forward the arm request to every decode
        and prefill replica; per-replica armed/refused results (a down
        replica reports armed=False with its error). Fleet-wide capture
        from one operator call — the serving face of the coordinated
        cross-host window."""
        payload = {"reason": str(body.get("reason") or "operator")}
        if body.get("span") is not None:
            payload["span"] = int(body["span"])
        results = []
        for rep in self._reps + self._pre:
            try:
                with _post_json(f"{rep.url}/profile", payload,
                                timeout=5.0) as resp:
                    results.append(json.loads(resp.read()))
            except urllib.error.HTTPError as e:
                try:
                    results.append(json.loads(e.read()))
                except Exception:
                    results.append({"replica": rep.idx, "armed": False,
                                    "error": str(e)})
            except Exception as e:  # noqa: BLE001 — dead replica
                results.append({"replica": rep.idx, "armed": False,
                                "error": str(e)})
        return {"reason": payload["reason"], "replicas": results}

    def trace(self, trace_id: str) -> dict:
        """Stitch one request's waterfall across this router and every
        replica (live ones answer /trace/<id>; dead ones contribute
        nothing) — the chief-side collector entry point."""
        urls = [r.url for r in self._reps] + [r.url for r in self._pre]
        return collect_trace(trace_id, urls,
                             local_events=_trace.events(trace_id))

    # -- placement ----------------------------------------------------------
    def _refresh_liveness(self) -> None:
        """Fold the chief aggregator's staleness view into the routing
        table: a replica whose metric pushes went stale is down even if
        the router has not yet hit a connection error on it. A replica
        that has never been ready gets TFDE_BOOT_READY_GRACE_S first —
        a joiner mid-compile-storm pushes late because it is busy
        booting, not because it died."""
        if self._agg is None:
            return
        grace = _boot.ready_grace_s()
        hosts = self._agg.hosts()
        now = time.monotonic()
        for rep in self._reps:
            info = hosts.get(rep.idx)
            if info is None or info["age"] <= self._agg.stale_after:
                continue
            if not rep.ready_seen and now - rep.first_seen < grace:
                continue
            self._mark_down(rep, f"stale push ({info['age']:.1f}s)")

    def _placeable(self, rep: _Replica) -> bool:
        """Readiness gate (decode tier): place only on replicas whose
        last /load snapshot said `ready` — or that the router has never
        snapshotted (fail open, the pre-readiness behavior for legacy
        replicas and direct-`_pick` callers)."""
        return rep.state in _boot.PLACEABLE_STATES

    def _pick(self, pool, exclude=()):
        self._refresh_liveness()
        gate = pool is self._reps and _boot.ready_require()
        with self._lock:
            cands = [r for r in pool
                     if r.up and not r.drained and r.idx not in exclude
                     and (not gate or self._placeable(r))]
            if not cands:
                raise LookupError("no live replicas")
            return min(cands, key=lambda r: r.outstanding)

    def _account(self, rep: _Replica, outstanding: int = 0,
                 served: int = 0) -> None:
        """Handler threads run concurrently while `_pick` reads the
        counters under the lock — every read-modify-write must be atomic
        or a lost update skews least-outstanding placement for the rest
        of the process lifetime."""
        with self._lock:
            rep.outstanding += outstanding
            rep.served += served

    def _mark_down(self, rep: _Replica, reason: str) -> None:
        with self._lock:
            if not rep.up:
                return
            rep.up = False
            # fail open like placement does: a replica the router never
            # snapshotted (state "unknown") gets legacy `lost`
            # accounting; only an OBSERVED not-yet-ready boot books as
            # never_ready
            ever_ready = rep.ready_seen or rep.state == "unknown"
            # the traces this death strands — the flight dump's
            # cross-reference into the request-trace timeline
            stranded = sorted(
                t for t, idx in self._inflight.items() if idx == rep.idx
            )
        log.warning("replica %d (%s) down: %s%s", rep.idx, rep.url, reason,
                    "" if ever_ready else " (never became ready)")
        # a replica that died WITHOUT ever reaching ready is a failed
        # boot, not lost serving capacity — the autoscaler reads these
        # two counters very differently
        self._reg.counter("router/replicas_lost" if ever_ready
                          else "router/replicas_never_ready").incr()
        self._reg.gauge(f"router/replica{rep.idx}/up").set(0)
        note_replica_down(rep.idx, reason)
        # the dead replica can't dump its own flight ring (SIGKILL);
        # the router's ring carries the routing-side story for it
        flightrec.record("replica_down", replica=rep.idx, reason=reason,
                         never_ready=not ever_ready, traces=stranded)
        flightrec.dump("replica_down")

    def drain(self, idx: int, tier: str = "decode") -> bool:
        """Stop placing new sessions on replica `idx` of `tier`
        ('decode' or 'prefill'); in-flight streams finish on their own.
        The graceful half of replica removal. Returns whether the index
        named a known replica."""
        if tier not in ("decode", "prefill"):
            raise ValueError(f"unknown drain tier {tier!r}")
        pool = self._pre if tier == "prefill" else self._reps
        label = "prefill" if tier == "prefill" else "replica"
        for rep in pool:
            if rep.idx == idx:
                with self._lock:
                    rep.drained = True
                self._reg.gauge(f"router/{label}{idx}/drained").set(1)
                flightrec.record("replica_drain", replica=idx, tier=tier)
                return True
        return False

    def mem_table(self) -> dict:
        """Per-replica memory & compile snapshot from the pushed metrics
        (the mem/* block on obs_dump --router): live device bytes, the
        largest registered program's peak, and the sentinel's total
        cache-miss count — enough to spot an HBM leak or a recompiling
        replica from the routing table without scraping each replica."""
        if self._agg is None:
            return {}
        out = {}
        for hid, flat in self._agg.host_metrics(("mem/", "compile/")).items():
            peaks = {name[len("mem/"):-len("/peak_bytes")]: v
                     for name, v in flat.items()
                     if name.startswith("mem/")
                     and name.endswith("/peak_bytes")}
            top = max(peaks.items(), key=lambda kv: kv[1], default=None)
            out[str(hid)] = {
                "live_bytes": flat.get("mem/live/bytes"),
                "live_buffers": flat.get("mem/live/buffers"),
                "peak_program": top[0] if top else None,
                "peak_bytes": top[1] if top else None,
                "compile_misses": sum(
                    v for name, v in flat.items()
                    if name.startswith("compile/")
                    and name.endswith("/misses")),
                "compile_seconds": flat.get("compile/seconds_total"),
            }
        return out

    def kv_table(self) -> dict:
        """Per-replica KV occupancy/headroom snapshot from the pushed
        metrics (the kv block on /replicas and obs_dump --capacity):
        how full each replica's dense slab is, what pad-ladder waste it
        carries, and how many more rows fit — the fleet's capacity
        picture without scraping each replica."""
        if self._agg is None:
            return {}
        out = {}
        for hid, flat in self._agg.host_metrics(("kv/",)).items():
            if "kv/allocated_bytes" not in flat:
                continue
            # worst pad-ladder cell: the bucket whose cumulative pad
            # waste is largest — the cells paged-KV would reclaim first
            pre = "kv/pad_waste_tokens/bucket_"
            buckets = {int(name[len(pre):]): v for name, v in flat.items()
                       if name.startswith(pre)}
            top = max(buckets.items(), key=lambda kv: kv[1], default=None)
            out[str(hid)] = {
                "allocated_bytes": flat.get("kv/allocated_bytes"),
                "used_bytes": flat.get("kv/used_bytes"),
                "waste_frac": flat.get("kv/waste_frac"),
                "rows_active": flat.get("kv/rows_active"),
                "rows_free": flat.get("kv/rows_free"),
                "headroom_rows": flat.get("kv/headroom_rows"),
                "headroom_tokens": flat.get("kv/headroom_tokens"),
                "trie_bytes": flat.get("kv/trie_bytes"),
                "pad_waste_tokens": flat.get("kv/pad_waste_tokens"),
                "top_waste_bucket": top[0] if top else None,
                "top_waste_bucket_tokens": top[1] if top else None,
            }
        return out

    def table(self) -> list:
        """Live routing table (the obs_dump --router surface)."""
        ages = self._agg.hosts() if self._agg is not None else {}
        rows = []
        for rep in self._reps:
            info = ages.get(rep.idx, {})
            rows.append({
                "replica": rep.idx,
                "url": rep.url,
                "up": rep.up,
                "drained": rep.drained,
                "state": "draining" if rep.drained else rep.state,
                "ready_seen": rep.ready_seen,
                "outstanding_tokens": rep.outstanding,
                "served": rep.served,
                "push_age_s": info.get("age"),
            })
        return rows

    def boot_table(self) -> dict:
        """Per-replica boot ledger (the /replicas `boot` block and
        obs_dump --boot surface): the cached /load snapshot's full
        ledger when the router has one, back-filled from the pushed
        boot/* gauges for replicas it has not snapshotted (e.g. a chief
        aggregating hosts the router never placed on)."""
        with self._lock:
            loads = dict(self._loads)
        out = {}
        for idx, ld in loads.items():
            if isinstance(ld, dict) and isinstance(ld.get("boot"), dict):
                out[str(idx)] = ld["boot"]
        if self._agg is not None:
            for hid, flat in self._agg.host_metrics(("boot/",)).items():
                if not flat or str(hid) in out:
                    continue
                phases = {
                    name: flat[g] for name, g in (
                        ("init", "boot/init_seconds"),
                        ("bootstrap", "boot/bootstrap_seconds"),
                        ("restore", "boot/restore_seconds"),
                        ("compile", "boot/compile_wall_seconds"),
                        ("warmup", "boot/warmup_seconds"),
                    ) if g in flat
                }
                out[str(hid)] = {
                    "state": None,   # gauges carry numbers, not the FSM
                    "phases": phases,
                    "time_to_ready_s": flat.get(
                        "boot/time_to_ready_seconds"),
                    "ttft_from_birth_ms": flat.get(
                        "boot/ttft_from_birth_ms"),
                    "restore": {"bandwidth_bps": flat.get(
                        "boot/restore_bandwidth_bps")},
                    "compile": {
                        "boot_count": flat.get("boot/compile_count"),
                        "boot_seconds": flat.get("boot/compile_seconds"),
                    },
                }
        return out

    def _publish(self) -> None:
        for rep in self._reps:
            g = self._reg.gauge
            g(f"router/replica{rep.idx}/up").set(int(rep.up))
            g(f"router/replica{rep.idx}/outstanding_tokens").set(
                rep.outstanding
            )
            g(f"router/replica{rep.idx}/served").set(rep.served)

    # -- overload protection -------------------------------------------------
    def _brownout_shed_rank(self) -> int:
        """The minimum PRIORITY_RANK this router currently sheds: 3 when
        brownout is off (no class has rank 3 — nothing sheds), 2 at
        level 1 (best_effort), 1 at level 2 (batch too). interactive
        (rank 0) is never brownout-shed. Level changes are edge-detected
        into a gauge + flight breadcrumb, the ProfileTrigger idiom."""
        level = 0
        count, att = self._slo.window_stats("ttft", self._slo.windows[0])
        if count >= 8 and att is not None:  # slo.MIN_BURN_SAMPLES
            burn = (1.0 - att) / (1.0 - self._slo.objective)
            if self._brownout_burn > 0 and burn >= self._brownout_burn:
                level = 1
            if (self._brownout_burn_batch > 0
                    and burn >= self._brownout_burn_batch):
                level = 2
        with self._lock:
            changed = level != self._brownout_level
            self._brownout_level = level
        if changed:
            self._reg.gauge("router/brownout_level").set(level)
            flightrec.record("brownout", level=level,
                             burn_threshold=self._brownout_burn)
            log.warning("brownout level -> %d", level)
        return 3 - level

    def _load_snapshot(self) -> dict:
        """replica idx -> its /load JSON, for live decode replicas,
        refreshed at most once per `_load_ttl`. A replica that fails the
        GET is simply absent (liveness is _pick's job, not this path's)."""
        now = time.monotonic()
        with self._lock:
            if now - self._loads_at < self._load_ttl:
                return self._loads
        loads = {}
        for rep in self._reps:
            if not rep.up or rep.drained:
                continue
            try:
                with urllib.request.urlopen(
                        rep.url + "/load", timeout=2.0) as resp:
                    loads[rep.idx] = json.loads(resp.read())
            except Exception:  # noqa: BLE001 — absent, not dead
                continue
        with self._lock:
            self._loads = loads
            self._loads_at = now
            # readiness refresh rides the same snapshot: every request
            # path calls this before _pick, so placement always gates on
            # a state at most _load_ttl old. A /load without `state` is
            # a legacy replica — treat as ready.
            for rep in self._reps:
                ld = loads.get(rep.idx)
                if ld is None:
                    continue
                rep.state = str(ld.get("state", "ready"))
                if rep.state == "ready":
                    rep.ready_seen = True
        return loads

    def _reject(self, handler, headers_sent: bool, reason: str,
                retry_after_s: float, tid: Optional[str]) -> None:
        """One well-formed 429 (or in-band SSE error when the stream is
        already open): counted per reason, breadcrumbed, Retry-After in
        integer seconds with the precise float in the body."""
        self._reg.counter("router/rejected_429").incr()
        self._reg.counter(f"router/rejected_{reason}").incr()
        flightrec.record("router_reject", reason=reason,
                         retry_after_s=round(retry_after_s, 3))
        body = {"error": "overloaded", "reason": reason,
                "retriable": True,
                "retry_after_s": round(retry_after_s, 3)}
        if headers_sent:
            _sse_write(handler.wfile, body)
        else:
            headers = {"Retry-After": str(max(1, math.ceil(retry_after_s)))}
            if tid:
                headers[_trace.HEADER] = tid
            ReplicaServer._send_json(handler, 429, body, headers=headers)

    # -- request path --------------------------------------------------------
    def _maybe_prime(self, body: dict, tid: Optional[str] = None):
        """Run the prefill on the prefill tier when configured; returns
        the primed JSON payload or None (fall back to a plain submit)."""
        if not self._pre or len(body["prompt"]) < self._pmin:
            return None
        exclude: list = []
        while True:
            try:
                rep = self._pick(self._pre, exclude)
            except LookupError:
                return None  # prefill tier down: decode replicas prefill
            try:
                self._account(rep, outstanding=len(body["prompt"]))
                try:
                    t0 = time.perf_counter()
                    with _post_json(
                        rep.url + "/prime",
                        {"prompt": body["prompt"],
                         "max_new_tokens": body["max_new_tokens"]},
                        self._timeout,
                        headers={_trace.HEADER: tid} if tid else None,
                    ) as resp:
                        out = json.loads(resp.read())
                    if _trace.active() and tid is not None:
                        # the router-observed prime round trip: the
                        # prefill replica's own serve/prime nests inside
                        _trace.event("router/prime", trace=tid,
                                     prefill_replica=rep.idx,
                                     dur=time.perf_counter() - t0)
                finally:
                    self._account(rep, outstanding=-len(body["prompt"]))
                self._account(rep, served=1)
                return out
            except urllib.error.HTTPError:
                return None   # request-specific: let the decode tier try
            except _DEAD as e:
                self._mark_down(rep, f"prime: {e}")
                exclude.append(rep.idx)

    def _serve_generate(self, handler, body: dict) -> None:
        """Route one session; re-route on replica death until first
        token, retriable SSE error after."""
        try:
            budget = int(body["max_new_tokens"])
            prompt = list(body["prompt"])
        except (KeyError, TypeError, ValueError):
            ReplicaServer._send_json(
                handler, 400, {"error": "need prompt + max_new_tokens"}
            )
            return
        try:
            priority = _admission.validate_priority(
                handler.headers.get(_admission.PRIORITY_HEADER)
                or body.get("priority"))
        except ValueError as e:
            ReplicaServer._send_json(handler, 400, {"error": str(e)})
            return
        ttft_deadline_ms = body.get("ttft_deadline_ms")
        stream = bool(body.get("stream", False))
        # every session has a trace id (honor the caller's, else mint):
        # propagation + echo-back are unconditional and cheap; span
        # RECORDING stays behind the TFDE_TRACE ring flag
        tid = handler.headers.get(_trace.HEADER) or _trace.new_id()
        t_req = time.perf_counter()
        self._reg.counter("router/requests").incr()
        if _trace.active():
            _trace.event("router/request", trace=tid,
                         prompt_tokens=len(prompt), budget=budget,
                         priority=priority)
        # brownout gate: under sustained SLO burn, the lowest classes
        # are turned away at the front door before any replica spends a
        # prefill on them
        if (_admission.PRIORITY_RANK[priority]
                >= self._brownout_shed_rank()):
            self._reject(handler, False, "brownout",
                         _admission.MIN_RETRY_AFTER_S * 4, tid)
            return
        # saturation gate: when EVERY live PLACEABLE replica's /load
        # snapshot says its admission controller would reject, fail fast
        # here with the fleet's best Retry-After instead of bouncing off
        # each replica (a warming joiner is not capacity yet, so it
        # neither saves nor dooms the fleet here)
        all_loads = self._load_snapshot()
        gated = _boot.ready_require()
        loads = {idx: ld for idx, ld in all_loads.items()
                 if not gated
                 or str(ld.get("state", "ready")) in _boot.PLACEABLE_STATES}
        sat = [ld for ld in loads.values() if ld.get("saturated")]
        if loads and len(sat) == len(loads):
            self._reject(handler, False, "saturated",
                         min(ld.get("retry_after_s", 1.0) for ld in sat),
                         tid)
            return
        primed_payload = self._maybe_prime(body, tid)
        headers_sent = False
        exclude: list = []
        sat429: list = []   # Retry-After estimates from per-replica 429s
        while True:
            try:
                rep = self._pick(self._reps, exclude)
            except LookupError:
                if sat429:
                    # every live replica answered 429: the cluster is
                    # saturated, not down — tell the client to back off,
                    # with the most optimistic replica's estimate
                    self._reject(handler, headers_sent, "saturated",
                                 min(sat429), tid)
                    return
                if headers_sent:
                    _sse_write(handler.wfile,
                               {"error": "no live replicas",
                                "retriable": True})
                else:
                    ReplicaServer._send_json(
                        handler, 503, {"error": "no live replicas"},
                        headers={_trace.HEADER: tid},
                    )
                return
            if exclude:
                self._reg.counter("router/reroutes").incr()
            if _trace.active():
                # one event per placement attempt: a re-routed request's
                # waterfall shows the dead replica AND the survivor
                _trace.event("router/attempt", trace=tid, replica=rep.idx,
                             rerouted=bool(exclude),
                             primed=primed_payload is not None)
            self._account(rep, outstanding=budget)
            with self._lock:
                self._inflight[tid] = rep.idx
            tokens: list = []
            relayed = 0
            t_first = None
            finished = False
            try:
                fwd_headers = {_trace.HEADER: tid,
                               _admission.PRIORITY_HEADER: priority}
                if primed_payload is not None:
                    req = _post_json(rep.url + "/generate_primed",
                                     primed_payload, self._timeout,
                                     headers=fwd_headers)
                else:
                    fwd_body = {"prompt": prompt,
                                "max_new_tokens": budget,
                                "priority": priority}
                    if ttft_deadline_ms is not None:
                        fwd_body["ttft_deadline_ms"] = float(
                            ttft_deadline_ms)
                    req = _post_json(
                        rep.url + "/generate", fwd_body, self._timeout,
                        headers=fwd_headers,
                    )
                with req as resp:
                    if stream and not headers_sent:
                        handler.send_response(200)
                        handler.send_header("Content-Type",
                                            "text/event-stream")
                        handler.send_header(_trace.HEADER, tid)
                        handler.end_headers()
                        headers_sent = True
                        _sse_write(handler.wfile,
                                   {"meta": {"trace": tid}})
                    for ev in sse_events(resp):
                        if "token" in ev:
                            if t_first is None:
                                t_first = time.perf_counter()
                            tokens.append(ev["token"])
                            if stream:
                                _sse_write(handler.wfile,
                                           {"token": ev["token"]})
                                relayed += 1
                        elif ev.get("shed"):
                            # the replica shed this request at dequeue
                            # (TTFT deadline) — retriable, and the
                            # replica itself is healthy. Relay the
                            # in-band error when streaming; for a
                            # buffered client the 429 moment has not
                            # passed yet, so map it back to one.
                            ra = float(ev.get(
                                "retry_after_s",
                                _admission.MIN_RETRY_AFTER_S))
                            if stream:
                                metrics.default_registry().counter(
                                    "router/relayed_shed").incr()
                                _sse_write(handler.wfile, ev)
                            else:
                                self._reject(handler, headers_sent,
                                             "deadline_shed", ra, tid)
                            return
                        elif ev.get("done"):
                            finished = True
                            break
                if not finished:
                    # close-delimited stream ended without `done`: the
                    # replica died mid-decode
                    raise ConnectionError("stream ended before done")
            except urllib.error.HTTPError as e:
                # request-level rejection (validation): the replica is
                # fine — forward the error, do NOT mark down. Once SSE
                # headers (and possibly body bytes) went out, a second
                # send_response would corrupt the stream — report
                # in-band instead
                detail = e.read().decode(errors="replace")
                if e.code == 429 and not headers_sent:
                    # this replica's admission gate said no — another
                    # may still have room (the /load snapshot is a TTL
                    # cache; it can lag). Remember its drain estimate
                    # and try the next one.
                    try:
                        ra = float(json.loads(detail)["retry_after_s"])
                    except (json.JSONDecodeError, KeyError, TypeError,
                            ValueError):
                        ra = _admission.MIN_RETRY_AFTER_S
                    sat429.append(ra)
                    exclude.append(rep.idx)
                    continue
                if headers_sent:
                    _sse_write(handler.wfile,
                               {"error": detail, "retriable": False})
                else:
                    ReplicaServer._send_json(handler, e.code,
                                             {"error": detail},
                                             headers={_trace.HEADER: tid})
                return
            except _DEAD as e:
                self._mark_down(rep, str(e))
                exclude.append(rep.idx)
                if stream and relayed:
                    # tokens already left the building: the client must
                    # retry itself (same prompt re-runs from scratch)
                    _sse_write(handler.wfile,
                               {"error": "replica_died",
                                "retriable": True, "relayed": relayed})
                    return
                continue   # nothing delivered yet: transparent re-route
            finally:
                with self._lock:
                    self._inflight.pop(tid, None)
                self._account(rep, outstanding=-budget)
                self._publish()
            self._account(rep, served=1)
            self._publish()
            # client-observed SLO accounting: TTFT spans queueing,
            # placement, any re-routes and the primed hand-off; TPOT is
            # the steady-state inter-token rate after the first
            t_done = time.perf_counter()
            n = len(tokens)
            if t_first is not None:
                ttft_ms = (t_first - t_req) * 1e3
                tpot_ms = ((t_done - t_first) * 1e3 / (n - 1)
                           if n > 1 else None)
                self._slo.record(ttft_ms=ttft_ms, tpot_ms=tpot_ms)
                _trace.note_exemplar("router/ttft_ms", ttft_ms, tid)
            if _trace.active():
                _trace.event("router/done", trace=tid, replica=rep.idx,
                             tokens=n, rerouted=bool(exclude),
                             dur=t_done - t_req)
            if stream:
                _sse_write(handler.wfile,
                           {"done": True, "tokens": tokens,
                            "replica": rep.idx, "trace": tid})
            else:
                ReplicaServer._send_json(
                    handler, 200,
                    {"tokens": tokens, "replica": rep.idx, "trace": tid},
                    headers={_trace.HEADER: tid},
                )
            return


# -- blocking client (tests / bench / examples) ------------------------------
def request_generate(router_url: str, prompt, max_new_tokens: int,
                     stream: bool = False, timeout: float = 120.0,
                     priority: Optional[str] = None,
                     ttft_deadline_ms: Optional[float] = None) -> dict:
    """POST one generation to a Router (or directly to a ReplicaServer's
    /generate). Returns {"tokens": [...], "replica": idx|None,
    "ttft_s": seconds-to-first-token, "events": n, "trace": id|None —
    the session's X-Tfde-Trace id for /trace/<id> lookups}. Raises the
    underlying urllib error on transport failure (a pre-stream overload
    rejection surfaces as HTTPError 429 with Retry-After) and
    RuntimeError on an in-stream retriable error (a deadline-shed
    mid-stream reads "deadline_shed")."""
    url = router_url.rstrip("/")
    path = "/v1/generate" if "/generate" not in url else ""
    t0 = time.perf_counter()
    payload = {"prompt": list(np.asarray(prompt).tolist()),
               "max_new_tokens": int(max_new_tokens), "stream": True}
    if priority is not None:
        payload["priority"] = str(priority)
    if ttft_deadline_ms is not None:
        payload["ttft_deadline_ms"] = float(ttft_deadline_ms)
    tokens: list = []
    ttft = None
    replica = None
    trace_id = None
    n_events = 0
    with _post_json(url + path, payload, timeout) as resp:
        trace_id = resp.headers.get(_trace.HEADER)
        for ev in sse_events(resp):
            n_events += 1
            if "token" in ev:
                if ttft is None:
                    ttft = time.perf_counter() - t0
                tokens.append(ev["token"])
            elif "meta" in ev:
                trace_id = ev["meta"].get("trace", trace_id)
            elif "error" in ev:
                raise RuntimeError(ev["error"])
            elif ev.get("done"):
                replica = ev.get("replica")
                trace_id = ev.get("trace", trace_id)
                break
    return {"tokens": tokens, "replica": replica, "ttft_s": ttft,
            "events": n_events, "trace": trace_id}
