"""Continuous batching — counterpart of `tfde_tpu/inference/server.py`.

A FIXED decode batch where a finished row is re-used for the next queued
request while the other rows keep decoding (`ContinuousBatcher`, the
dense `role='both'` path of the JAX batcher):

- admission groups the queue by prompt BUCKET (powers of two up to
  max_len): every freed row of one bucket prefills in one call over a
  right-padded [R, bucket] batch into a fresh zero row cache, samples its
  first token at the row's true last position, and lands in the batch
  cache with one multi-row scatter. Wave sizes ride a power-of-two ladder;
  padding repeats row 0, whose duplicate scatter writes are identical.
  The prefill's attention is the flash kernel on a CUDA tensor
  (models/transformer.MultiHeadAttention._decode_attention);
- a decode round runs K = `scan_depth` ticks (K adapts down the ladder
  near a completion) over the whole batch with the loop state on the
  device: each tick feeds every row's pending token, samples the next
  one, and freezes finished rows — they feed `pad_id`, their index,
  budget and position stop, and their pad K/V lands beyond the committed
  count where no mask reaches it;
- the host fetches the [B, K] tokens and emitted flags once per round
  and replays them into per-row bookkeeping (EOS, budget, queue).

Invariant per active row r: the cache holds K/V for exactly
`committed[r]` tokens and `tok[r]` is the last generated-but-unfed token.
Greedy outputs equal a solo `generate` run token for token, whatever
shares the batch.

Two cache layouts beside that dense slab, as in JAX:

- the prefix-KV cache (`prefix_cache=`, or ``TFDE_PREFIX_CACHE``;
  inference/prefix_cache.py): a request whose prompt starts with cached
  whole blocks is a WARM admission: the cached K/V land in a fresh row
  cache and only the suffix prefills (`_warm_wave`: the masked einsum at
  index pre_len, never the flash kernel), grouped by (prefix length,
  suffix bucket); a cold wave's complete prompt blocks enter the trie;
- paged KV (`paged=True`, or ``TFDE_PAGED_KV``; inference/paged.py): one
  pool of `kv_block`-token blocks (`pool_blocks`, default `batch_size *
  nmax + 1`) with a block table a row, shared with the paged trie by
  refcount. Every admission, cold or warm, feeds its prompt through one
  [B, chunk] program chunk by chunk (`_paged_wave`); admission holds a
  request back while its lifetime blocks do not fit (a capacity stall,
  which may defragment the pool), and the trie is the pool's evictor.

`cancel(rid)` drops a queued request or frees its row (a paged row's
blocks return to the pool).

int8 KV (`kv_quant='int8'`, or ``TFDE_KV_QUANT=int8``): every cache the
batcher builds (the slab or the pool, the wave's row caches, the trie's
segments) holds int8 payloads and fp32 scale planes
(`decode.init_cache(..., kv_quant=)`); the model quantizes on write and
dequantizes on read (models/transformer.py), and a cold wave still
prefills on the flash kernel, over the dequantized K/V.

The KV capacity ledger (observability/capacity.py), wired once the slab
or pool exists: `kv_stats()` reports occupancy (allocated and used
bytes, waste, rows, the pool's blocks), the dtype census and the
headroom under ``TFDE_CAPACITY_BUDGET_BYTES``, and refreshes the
``kv/*`` gauges (after every step too); every admitted request notes its
pad-ladder cells. `usage` meters every request's prompt and generated
tokens and KV residency from submit to completion or cancel, into
``usage/*`` counters and the ``TFDE_USAGE_LOG`` journal
(`arm_usage_log`).

`stats()` counts dispatches and syncs in the JAX batcher's units: one per
device program the JAX batcher would run (row template, prefill, scatter,
seen update, state upload, block-table upload, prefill chunk, decode
round) and one per blocking fetch.

Admission control (`admission_ctl=`, default an
`admission.AdmissionController` from the ``TFDE_ADMIT_*`` knobs, every
cap off): `submit` and `submit_primed` pass one gate (`_admission_check`:
the queue-depth and queued-token caps, the forced-overload lever and,
when ``TFDE_ADMIT_KV_HEADROOM`` is set, the `kv_stats()` headroom
floor) or raise `admission.QueueFull` with a Retry-After from the drain
rate EWMA that every decode round feeds (`note_drain`). The queue drains
by priority class (`interactive` > `batch` > `best_effort`, FIFO within
one); a request whose TTFT deadline passed while it queued is shed at
dequeue, before any prefill (`_maybe_shed`, `was_shed`). `enable_progress`
/ `take_progress` stream each request's tokens as they land;
`_publish_stats` mirrors `stats()` and the queue into the
``serving/batcher/*`` gauges after every step.

The prefill/decode role split (`role=`): a 'prefill' replica serves only
`prime()` (one cold one-row prefill at the prompt's bucket on a fresh
dense row cache, its attention on the flash kernel on a CUDA tensor; the
row's K/V planes and the first token come back to the host in one sync
as a `PrimedRequest`), a 'decode' replica refuses `prime()` and admits
`submit_primed()` hand-offs beside plain submits: a 'primed' group lands
the shipped planes with one scatter (the dense rows, or the pool blocks
of a paged batcher) and runs no model FLOPs and no sync. The wire format
(`inference/router.py`) is the JAX package's. At temperature > 0 a primed
request's first token was drawn from the prefill replica's generator.

`SpeculativeContinuousBatcher` composes continuous batching with
speculative decoding (inference/speculative.py): a target slab and a
draft slab of max_len + num_draft + 1 cells a row; each admission wave
prefills both on fresh row caches at index 0 (the flash kernel on a CUDA
tensor) through the shared cold-wave helper and lands them with one
scatter a cache; each round rewinds both caches to the rows' committed
counts, runs the draft and verify forwards for the whole batch and fetches
(round tokens, counts) once. Like JAX's, it takes no prefix cache, paged
pool, int8 KV argument or primed hand-off.

Not ported yet (ROADMAP queue 1 item 4): spans, trace (`trace=` other
than None raises) and the flight recorder.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from tfde_tpu_torch import knobs
from tfde_tpu_torch.inference import admission as _admission
from tfde_tpu_torch.inference import paged as _paged
from tfde_tpu_torch.inference.decode import (
    KVCache,
    check_planes,
    init_cache,
    remat_off,
    resolve_kv_quant,
    sample_logits,
    validate_budget,
)
from tfde_tpu_torch.inference.prefix_cache import (
    DEFAULT_BLOCK,
    resolve as _resolve_prefix,
)
from tfde_tpu_torch.inference.speculative import fetch_round, run_round
from tfde_tpu_torch.observability import capacity as _capacity
from tfde_tpu_torch.observability import metrics
from tfde_tpu_torch.utils.devices import resolve_device


def _fetch(tensors):
    """THE host sync: one blocking device->host copy per round."""
    return [t.cpu().numpy() for t in tensors]


def _fetch_planes(planes: dict, tok: torch.Tensor):
    """One device->host copy of every plane in `planes` and the tokens
    `tok`: their bytes go into one flat buffer on the device (each part
    padded to 8 bytes, so every view back is aligned), cross once, and
    are cut back into host tensors. Returns ({name: host tensor}, tok as
    np.int64)."""
    parts, spans, at = [], [], 0
    for t in list(planes.values()) + [tok.to(torch.int64)]:
        raw = t.contiguous().view(torch.uint8).reshape(-1)
        pad = -raw.numel() % 8
        parts.append(raw)
        if pad:
            parts.append(raw.new_zeros(pad))
        spans.append((at, raw.numel()))
        at += raw.numel() + pad
    flat = torch.cat(parts).cpu()
    out = {}
    for (name, t), (start, n) in zip(planes.items(), spans):
        out[name] = flat[start:start + n].view(t.dtype).reshape(t.shape)
    start, n = spans[-1]
    return out, flat[start:start + n].view(torch.int64).numpy()


def _no_trace(trace) -> None:
    """The JAX batcher's `trace=` (a distributed-trace id): the port has
    no trace module yet."""
    if trace is not None:
        raise NotImplementedError(
            "trace=: request tracing is not ported (ROADMAP queue 1 item 4)")


@dataclasses.dataclass
class PrimedRequest:
    """A prefill-role replica's hand-off unit: everything a decode replica
    needs to admit the request without running the prompt forward. `kv`
    holds HOST tensors by plane name (`KVCache.planes()`: `(layer, 'k' |
    'v')`, and `'k_scale' | 'v_scale'` for an int8 cache), each [P, ...]
    over the prompt's cells, so the object is process-portable:
    inference/router.py ships it as the JAX package's JSON. Greedy
    decoding of a primed request equals a locally admitted one; at
    temperature > 0 the first token was drawn from the PREFILL replica's
    generator."""

    prompt: np.ndarray          # [P] int token ids
    first_token: int            # sampled at prefill time (pending, unfed)
    max_new_tokens: int
    kv: dict                    # plane name -> host tensor [P, ...]


@torch.no_grad()
def _decode_scan(model, cache: KVCache, tok, idx, budget, done, seen,
                 generator, depth: int, temperature, top_k, top_p, min_p,
                 repetition_penalty, eos_id, pad_id):
    """`depth` decode ticks for the whole batch, state on the device.

    Carry per row: `tok` the pending token, `idx` the committed count,
    `budget` the remaining output tokens, `done` the frozen flag, plus the
    optional [B, V] `seen` mask. Returns the carry and (toks [B, K],
    emitted [B, K]); `emitted[r]` is a True-prefix per row."""
    toks, emitted = [], []
    pad = torch.full_like(tok, pad_id)
    rows = torch.arange(tok.shape[0], device=tok.device)
    for _ in range(depth):
        # index surgery each tick: frozen rows must not advance
        cache.set_index(idx)
        feed = torch.where(done, pad, tok)
        logits = model(feed[:, None], cache=cache)[:, -1]
        nxt = sample_logits(logits, generator, temperature=temperature,
                            top_k=top_k, top_p=top_p, min_p=min_p,
                            repetition_penalty=repetition_penalty, seen=seen)
        live = ~done
        nxt = torch.where(done, pad, nxt)
        if seen is not None:
            marked = seen.clone()
            marked[rows, nxt] = True
            seen = torch.where(done[:, None], seen, marked)
        step = live.to(idx.dtype)
        idx = idx + step
        budget = budget - step
        fin = budget <= 0
        if eos_id is not None:
            fin = fin | (nxt == eos_id)
        done = done | (live & fin)
        tok = torch.where(live, nxt, tok)
        toks.append(nxt)
        emitted.append(live)
    return (tok, idx, budget, done, seen, torch.stack(toks, dim=1),
            torch.stack(emitted, dim=1))


def _prefill_logits(model, row_cache: KVCache, feed: np.ndarray,
                    last: np.ndarray) -> torch.Tensor:
    """Run `feed` [R, S] into `row_cache` from its index (index 0 on a
    fresh row cache: the flash prefill) and return each row's logits at
    its true last position `last` [R]: [R, V] fp32, the head on R
    positions only."""
    dev = model.device
    h = model.hidden(torch.as_tensor(feed, device=dev), cache=row_cache)
    rows = torch.arange(feed.shape[0], device=dev)
    return model.head(h[rows, torch.as_tensor(last, device=dev)])


def _normalize_buckets(buckets, max_len: int) -> tuple:
    """Sorted prefill bucket lengths; default powers of two from 8 up to
    max_len. Every prompt pads up to the smallest bucket that fits."""
    if buckets is None:
        buckets, b = [], 8
        while b < max_len:
            buckets.append(b)
            b *= 2
        buckets.append(max_len)
    out = tuple(sorted({min(int(b), max_len) for b in buckets}))
    if not out or out[-1] < max_len:
        raise ValueError(
            f"prompt_buckets must cover max_len {max_len}; got {out}")
    return out


def _bucketed(prompt: np.ndarray, buckets: tuple, pad_id: int):
    """(padded [1, bucket] int64 prompt, true-last-position index)."""
    p = prompt.size
    bucket = next(b for b in buckets if b >= p)
    padded = np.full((1, bucket), pad_id, np.int64)
    padded[0, :p] = prompt
    return padded, p - 1


def _ladder_depth(cap: int, bound: int) -> int:
    """The largest value of {1, 2, 4, ..., cap} (cap included) <= bound."""
    bound = min(cap, max(1, bound))
    if bound >= cap:
        return cap
    k = 1
    while k * 2 <= bound:
        k *= 2
    return k


def _pad_wave(r: int, cap: int) -> int:
    """Admission wave sizes on a power-of-two ladder capped at the batch."""
    k = 1
    while k < r:
        k *= 2
    return min(k, cap)


class _PriorityDeque:
    """One FIFO lane per priority class, drained highest-priority-first;
    iteration walks the lanes in drain order."""

    def __init__(self):
        self._lanes = collections.OrderedDict(
            (p, collections.deque()) for p in _admission.PRIORITIES)

    def append(self, item,
               priority: str = _admission.DEFAULT_PRIORITY) -> None:
        self._lanes[priority].append(item)

    def appendleft(self, item,
                   priority: str = _admission.DEFAULT_PRIORITY) -> None:
        """Put a dequeued item back at the front of its lane (the
        capacity stall: nothing behind it overtakes it)."""
        self._lanes[priority].appendleft(item)

    def remove_rid(self, rid: int) -> bool:
        """Drop the queued item with request id `rid` (cancel)."""
        for lane in self._lanes.values():
            for i, item in enumerate(lane):
                if item[0] == rid:
                    del lane[i]
                    return True
        return False

    def popleft(self):
        for lane in self._lanes.values():
            if lane:
                return lane.popleft()
        raise IndexError("pop from an empty priority queue")

    def depths(self) -> dict:
        """Queue depth of each priority class."""
        return {p: len(lane) for p, lane in self._lanes.items()}

    def __len__(self) -> int:
        return sum(len(lane) for lane in self._lanes.values())

    def __bool__(self) -> bool:
        return any(self._lanes.values())

    def __iter__(self):
        for lane in self._lanes.values():
            yield from lane


class _BatcherBase:
    """The request queue, per-row host bookkeeping (`_take_token`),
    admission control (`submit`/`submit_primed` through
    `_admission_check`, deadline shedding at dequeue), `cancel`, the
    progress stream, wave admission (`_admit` plans groups with
    `_plan_wave` and runs each with `_run_group`; the subclass supplies
    the waves and the capacity hooks), the usage meter, the capacity
    ledger (the subclass wires it with `_init_capacity` once its cache
    exists) and the ``serving/batcher/*`` gauges (`_publish_stats`)."""

    _metrics_prefix = "serving/batcher"
    #: subclasses that implement `_primed_wave` and `prime` flip this
    _accepts_primed = False

    def __init__(self, model, batch_size: int, max_len: int, eos_id,
                 pad_id: int, prompt_buckets, device, role: str = "both",
                 admission_ctl=None):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        if role not in ("both", "prefill", "decode"):
            raise ValueError(
                f"role must be 'both', 'prefill' or 'decode', got {role!r}")
        self._device = resolve_device(device)
        if model.device != self._device:
            raise ValueError(f"model is on {model.device}, the batcher was "
                             f"asked for {self._device}")
        self._buckets = _normalize_buckets(prompt_buckets, max_len)
        self._model = model
        self._b = batch_size
        self._max_len = int(max_len)
        self._eos = eos_id
        self._pad = pad_id
        self._role = role
        self._req = [None] * batch_size          # request id or None
        self._out = [[] for _ in range(batch_size)]
        self._budget = np.zeros(batch_size, np.int64)
        self._committed = np.zeros(batch_size, np.int64)
        self._tok = np.full(batch_size, pad_id, np.int64)
        # queue items: (rid, prompt [P] np.int64, budget, primed or None);
        # `primed` is set only for submit_primed() entries (K/V in hand)
        self._queue = _PriorityDeque()
        # admission policy: caps + drain-rate estimate (the default reads
        # TFDE_ADMIT_*; every cap off unless configured)
        self._admission = (admission_ctl if admission_ctl is not None
                           else _admission.AdmissionController())
        self._priority: dict = {}
        self._deadline_at: dict = {}  # rid -> absolute TTFT deadline
        self._shed: set = set()       # rids deadline-shed at dequeue
        self._submitted_at: dict = {}
        self._ttft_ms: dict = {}
        self._queue_ms: dict = {}
        self._reused: dict = {}  # rid -> prompt tokens served from a cache
        self._next_id = 0
        self._rounds = 0       # decode ticks run
        self._generated = 0    # every delivered token (incl. prefill 1st)
        self._dispatches = 0   # device programs in the JAX batcher's units
        self._syncs = 0        # blocking device->host fetches
        self._waves = 0        # prefill waves run
        self._wave_kinds = collections.Counter()
        self._stalls = 0       # admissions held back on cache capacity
        self._short = False    # a wave gave requests back (paged)
        self._prefill_s = 0.0  # host seconds in prefill waves (each ends
        self._decode_s = 0.0   # in a sync) and in decode rounds
        # per-request incremental delivery (`enable_progress`): off by
        # default, since an unread stream entry would stay forever
        self._track_progress = False
        self._stream: dict = {}  # rid -> {"tokens", "taken", "done"}
        # KV capacity: the ledger and headroom model once the subclass's
        # cache exists (`_init_capacity`); the usage meter from the start
        # (its JSONL log arms from TFDE_USAGE_LOG or `arm_usage_log`)
        self._ledger = None
        self._cap_model = None
        self._usage = _capacity.UsageMeter()

    @property
    def idle(self) -> bool:
        return not self._queue and all(r is None for r in self._req)

    @property
    def free_rows(self) -> int:
        return sum(r is None for r in self._req)

    @property
    def role(self) -> str:
        """'both', 'prefill' (serves `prime()` only) or 'decode' (refuses
        `prime()`, admits `submit_primed()` beside `submit()`)."""
        return self._role

    @property
    def admission(self) -> "_admission.AdmissionController":
        return self._admission

    @property
    def outstanding_tokens(self) -> int:
        """Remaining output-token budget across active rows plus the
        queue: the least-loaded placement signal of a router."""
        active = sum(int(self._budget[r]) for r in range(self._b)
                     if self._req[r] is not None)
        return active + self.queued_tokens

    @property
    def queued_tokens(self) -> int:
        """Output-token backlog of QUEUED requests only (active rows are
        already paid for): the admission cap's and the drain estimate's
        unit."""
        return sum(int(item[2]) for item in self._queue)

    def ttft_ms(self) -> dict:
        """{request id: ms from submit to its first token} so far."""
        return dict(self._ttft_ms)

    def queue_ms(self) -> dict:
        """{request id: ms from submit to the start of its admission
        wave} so far: the part of its TTFT spent waiting for a row."""
        return dict(self._queue_ms)

    def reused_tokens(self) -> dict:
        """{request id: prompt tokens its admission took from the prefix
        cache} so far (0: a cold or primed admission)."""
        return dict(self._reused)

    def wave_counts(self) -> dict:
        """Prefill waves run, by kind: 'cold' (a dense bucket prefill,
        the flash kernel's wave), 'warm' (a dense suffix prefill after a
        prefix hit), 'paged' (the chunked paged prefill), 'primed' (the
        scatter of shipped K/V: no model FLOPs)."""
        return dict(self._wave_kinds)

    @property
    def usage(self) -> "_capacity.UsageMeter":
        """The per-request usage meter (`totals()`, `log_path`)."""
        return self._usage

    def arm_usage_log(self, model_dir=None) -> None:
        """Late-bind the usage JSONL log (``TFDE_USAGE_LOG=on`` needs a
        model_dir to anchor the file)."""
        self._usage.arm(model_dir)

    def _init_capacity(self, cache, cells_per_row: Optional[int] = None
                       ) -> None:
        """The occupancy ledger and headroom model of the dense slab
        `cache` ([B, cells_per_row] cells a layer; default max_len: the
        speculative batcher's slab carries the draft's slack past it)."""
        self._ledger = _capacity.CapacityLedger.from_cache(
            cache, self._b, cells_per_row or self._max_len)
        self._cap_model = _capacity.CapacityModel(self._ledger)

    def kv_stats(self) -> dict:
        """KV occupancy, the dtype census and headroom (rows, tokens);
        refreshes the kv/* gauges. Empty until the cache is wired."""
        if self._ledger is None:
            return {}
        s = self._ledger.observe(self._committed, self._req)
        s.update(self._cap_model.headroom(s))
        return s

    @property
    def capacity_stalls(self) -> int:
        """Times admission held a request back because its cache blocks
        did not fit (paged only)."""
        return self._stalls

    def was_shed(self, rid: int) -> bool:
        """True exactly once for a request that was deadline-shed at
        dequeue (an HTTP layer turns its empty completion into an
        explicit shed event)."""
        if rid in self._shed:
            self._shed.discard(rid)
            return True
        return False

    def submit(self, prompt, max_new_tokens: int, trace=None,
               priority: Optional[str] = None,
               ttft_deadline_ms: Optional[float] = None) -> int:
        """Queue a request; returns its id. prompt: 1-D int token ids.
        `trace`: the JAX batcher's trace id; only None (tracing is not
        ported). `priority`: 'interactive' (default; None and '' too) >
        'batch' > 'best_effort', case and surrounding blanks ignored; the
        queue drains highest-priority-first. `ttft_deadline_ms`: shed the
        request at dequeue if its queue wait alone passed this budget
        (default: the controller's ``TFDE_ADMIT_TTFT_DEADLINE_MS``).
        Raises `admission.QueueFull` when a configured cap binds; a
        rejected submit takes no request id and leaves no state."""
        if self._role == "prefill":
            raise RuntimeError(
                "prefill-only replica: use prime() and hand the result to "
                "a decode replica's submit_primed()")
        _no_trace(trace)
        prompt = self._check_request(prompt, max_new_tokens)
        pr = _admission.validate_priority(priority)
        self._admission_check(int(max_new_tokens))
        return self._enqueue(prompt, int(max_new_tokens), None, pr,
                             ttft_deadline_ms)

    def submit_primed(self, primed: PrimedRequest, trace=None,
                      priority: Optional[str] = None,
                      ttft_deadline_ms: Optional[float] = None) -> int:
        """Queue a request whose prefill already ran on a prefill-role
        replica (`prime()`): only the K/V scatter and the decode happen
        here. A payload of another cache layout (full precision into
        int8, int8 without its scale planes, other widths) raises
        ValueError. Returns the local request id."""
        if not self._accepts_primed:
            raise RuntimeError(
                f"{type(self).__name__} does not accept primed requests")
        if self._role == "prefill":
            raise RuntimeError("prefill-only replica cannot decode")
        _no_trace(trace)
        prompt = self._check_request(primed.prompt, primed.max_new_tokens)
        self._check_primed(primed, prompt)
        pr = _admission.validate_priority(priority)
        self._admission_check(int(primed.max_new_tokens))
        return self._enqueue(prompt, int(primed.max_new_tokens), primed, pr,
                             ttft_deadline_ms)

    def _check_primed(self, primed: PrimedRequest,
                      prompt: np.ndarray) -> None:
        """A primed payload must fit this batcher's cache layout."""

    def _admission_check(self, budget: int) -> None:
        """One admission gate for both submit paths: the queue caps, and
        when a ledger is wired and ``min_headroom_rows`` set the memory
        gate, with the kv snapshot riding any rejection and the
        outstanding decode backlog as the Retry-After basis when headroom
        (not queue depth) binds."""
        if self._ledger is not None and self._admission.min_headroom_rows:
            kv = self.kv_stats()
            self._admission.check(
                len(self._queue), self.queued_tokens, budget,
                headroom_rows=kv.get("headroom_rows"), kv=kv,
                drain_tokens=self.outstanding_tokens)
        else:
            self._admission.check(len(self._queue), self.queued_tokens,
                                  budget)

    def _check_request(self, prompt, max_new_tokens: int) -> np.ndarray:
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        if prompt.size < 1:
            raise ValueError("prompt must have at least one token")
        if max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}")
        if prompt.size + max_new_tokens > self._max_len:
            raise ValueError(
                f"prompt ({prompt.size}) + max_new_tokens ({max_new_tokens}) "
                f"exceeds the batcher's max_len {self._max_len}")
        self._validate_submit(prompt, max_new_tokens)
        return prompt

    def _enqueue(self, prompt: np.ndarray, budget: int, primed,
                 priority: str, ttft_deadline_ms: Optional[float]) -> int:
        rid = self._next_id
        self._next_id += 1
        self._queue.append((rid, prompt, budget, primed), priority=priority)
        now = time.perf_counter()
        self._priority[rid] = priority
        self._submitted_at[rid] = now
        self._usage.begin(rid, int(prompt.size), priority)
        dl = (float(ttft_deadline_ms) if ttft_deadline_ms is not None
              else self._admission.ttft_deadline_ms)
        if dl and dl > 0:
            self._deadline_at[rid] = now + dl / 1e3
        if self._track_progress:
            self._stream[rid] = {"tokens": [], "taken": 0, "done": False}
        return rid

    def enable_progress(self) -> None:
        """Track each request's tokens for `take_progress` (a streaming
        front end's feed). Applies to requests submitted after the
        call."""
        self._track_progress = True

    def take_progress(self, rid: int):
        """(new tokens since the last take, done flag) of a request
        submitted after `enable_progress()`. The take that drains a
        finished request's entry drops it; a shed request is done with no
        tokens."""
        ent = self._stream[rid]
        toks = ent["tokens"][ent["taken"]:]
        ent["taken"] += len(toks)
        if ent["done"] and ent["taken"] == len(ent["tokens"]):
            del self._stream[rid]
        return toks, ent["done"]

    def run(self) -> list:
        """Step until idle; returns every completion in finish order."""
        done = []
        while not self.idle:
            done.extend(self.step())
        return done

    def cancel(self, rid: int) -> bool:
        """Abandon a request whose consumer is gone: drop it from the
        queue, or free its row so the decode rounds stop spending ticks
        on it (a paged row's blocks return to the pool). Partial output
        is discarded, and so are its stream entry and deadline. Returns
        whether the request was found in flight."""
        self._stream.pop(rid, None)
        self._submitted_at.pop(rid, None)
        self._priority.pop(rid, None)
        self._deadline_at.pop(rid, None)
        self._shed.discard(rid)
        if self._queue.remove_rid(rid):
            self._usage.finish(rid, 0, outcome="cancelled")
            return True
        for r in range(self._b):
            if self._req[r] == rid:
                self._usage.finish(rid, len(self._out[r]),
                                   outcome="cancelled")
                self._release_row(r)
                self._req[r] = None
                self._out[r] = []
                self._budget[r] = 0
                self._committed[r] = 0
                self._tok[r] = self._pad
                # the device loop state still holds the row as live: a
                # rebuild flips its done flag before the next round
                self._mark_dirty()
                return True
        return False

    def _publish_stats(self) -> None:
        """Mirror `stats()` and the queue into the ``serving/batcher/*``
        gauges (queue_depth, free_rows, outstanding_tokens, queued_tokens,
        drain_rate_tps) and refresh the kv/* gauges (`kv_stats`)."""
        reg = metrics.default_registry()
        pre = self._metrics_prefix
        for k, v in self.stats().items():
            reg.gauge(f"{pre}/{k}").set(v)
        reg.gauge(f"{pre}/queue_depth").set(len(self._queue))
        reg.gauge(f"{pre}/free_rows").set(self.free_rows)
        reg.gauge(f"{pre}/outstanding_tokens").set(self.outstanding_tokens)
        reg.gauge(f"{pre}/queued_tokens").set(self.queued_tokens)
        reg.gauge(f"{pre}/drain_rate_tps").set(
            self._admission.drain_rate_tps)
        self.kv_stats()

    def _validate_submit(self, prompt: np.ndarray,
                         max_new_tokens: int) -> None:
        validate_budget(self._model, int(prompt.size), max_new_tokens)

    def _prefill_wave(self, prompts: np.ndarray, last: np.ndarray,
                      rows: np.ndarray, plens: np.ndarray,
                      n: int) -> np.ndarray:
        """Prefill + scatter one padded wave; returns the [R] first
        tokens. Rows past `n` are ladder padding (duplicates of row 0)."""
        raise NotImplementedError

    def _primed_wave(self, bucket: int, group, rows) -> np.ndarray:
        raise NotImplementedError(
            "primed admission requires a subclass with _accepts_primed")

    def _release_row(self, r: int) -> None:
        """Row `r` just left the batch (completion or cancel): return its
        cache resources. The dense slab has none."""

    def _admission_cost(self, item) -> int:
        """Pool blocks queue `item` claims at admission (0: the dense
        slab, where a free row is the capacity)."""
        return 0

    def _admit_capacity(self, need: int, reserved: int) -> bool:
        """Can the cache grant `need` more blocks beside the `reserved`
        ones of the wave so far? On False the item goes back to the front
        of its lane and admission stalls."""
        return True

    def _on_capacity_stall(self) -> None:
        """Admission just stalled on capacity (the paged batcher's
        defrag pass)."""

    def _prefix_len(self, kind: str, key, item) -> int:
        """Prompt tokens of `item` that its admission took from a cache."""
        return 0

    def _admission_cells(self, kind: str, key, item) -> tuple:
        """(allocated cells, real tokens) of one admitted request's
        prefill, the ledger's pad-waste unit: the bucket and the prompt
        (a warm group's suffix bucket and suffix; a primed group's
        bucket and prompt). The paged batcher counts blocks."""
        prompt = item[1]
        if kind == "warm":
            return int(key[1]), int(prompt.size) - int(key[0])
        return int(key), int(prompt.size)

    def _take_token(self, r: int, t: int) -> list:
        """Record a sampled token for row r; frees the row on completion."""
        self._out[r].append(t)
        self._budget[r] -= 1
        self._tok[r] = t
        self._generated += 1
        ent = self._stream.get(self._req[r]) if self._track_progress else None
        if ent is not None:
            ent["tokens"].append(int(t))
        if self._budget[r] <= 0 or (self._eos is not None and t == self._eos):
            if ent is not None:
                ent["done"] = True
            rid = self._req[r]
            done = (rid, np.asarray(self._out[r], np.int32))
            self._priority.pop(rid, None)
            self._deadline_at.pop(rid, None)
            self._usage.finish(rid, len(self._out[r]), outcome="ok")
            self._release_row(r)
            self._req[r] = None
            self._out[r] = []
            self._committed[r] = 0
            self._tok[r] = self._pad
            return [done]
        return []

    def _plan_wave(self, wave) -> list:
        """Group one admission wave into prefill groups: [(kind, key,
        items)], items (rid, prompt, budget, primed, extra). Here 'cold'
        and 'primed' (K/V in hand: a scatter only) group by prompt
        bucket; the batcher adds 'warm' and 'paged'."""
        cold: dict = collections.OrderedDict()
        primed: dict = collections.OrderedDict()
        for rid, prompt, budget, pr in wave:
            bucket = next(b for b in self._buckets if b >= prompt.size)
            dst = primed if pr is not None else cold
            dst.setdefault(bucket, []).append((rid, prompt, budget, pr, None))
        return ([("cold", b, g) for b, g in cold.items()]
                + [("primed", b, g) for b, g in primed.items()])

    def _run_group(self, kind: str, key, group, rows) -> np.ndarray:
        if kind == "cold":
            return self._cold_wave(key, group, rows)
        if kind == "primed":
            return self._primed_wave(key, group, rows)
        raise ValueError(f"unknown admission kind {kind!r}")

    def _cold_wave(self, bucket: int, group, rows) -> np.ndarray:
        n = len(group)
        rp = _pad_wave(n, self._b)
        prompts = np.full((rp, bucket), self._pad, np.int64)
        last = np.zeros(rp, np.int64)
        plens = np.zeros(rp, np.int64)
        rows_pad = np.asarray(rows + [rows[0]] * (rp - n), np.int64)
        for i in range(rp):
            # wave padding repeats row 0's request verbatim: its prefill
            # K/V is identical, so duplicate scatter writes never race
            prompt = group[i if i < n else 0][1]
            prompts[i, :prompt.size] = prompt
            last[i] = prompt.size - 1
            plens[i] = prompt.size
        return self._prefill_wave(prompts, last, rows_pad, plens, n)

    def _admit(self) -> list:
        """Fill free rows from the queue a group wave at a time. Every
        admitted row holds one pending token afterwards; a request that
        finishes on its first token frees its row within the same call.
        A request whose TTFT deadline passed in the queue is shed at
        dequeue (`_maybe_shed`), before the capacity gate. A request
        whose cache blocks do not fit goes back to the front of its lane,
        and admission stops until a completion frees blocks (head of
        line, on purpose: skipping ahead would starve big requests)."""
        finished = []
        stalled = False
        while self._queue and self.free_rows and not stalled:
            free = [r for r in range(self._b) if self._req[r] is None]
            wave = []
            reserved = 0
            self._short = False
            while self._queue and len(wave) < len(free):
                item = self._queue.popleft()
                # a request whose queue wait alone blew its TTFT budget
                # is dead on arrival: no wave is spent on it
                if self._maybe_shed(item):
                    continue
                need = self._admission_cost(item)
                if need and not self._admit_capacity(need, reserved):
                    self._queue.appendleft(
                        item, priority=self._priority.get(
                            item[0], _admission.DEFAULT_PRIORITY))
                    self._stalls += 1
                    self._on_capacity_stall()
                    stalled = True
                    break
                reserved += need
                wave.append(item)
            taken = 0
            for kind, key, group in self._plan_wave(wave):
                n = len(group)
                rows = free[taken:taken + n]
                taken += n
                t0 = time.perf_counter()
                toks = self._run_group(kind, key, group, rows)
                now = time.perf_counter()
                self._prefill_s += now - t0  # each wave ends in a fetch
                if not group:  # every request given back (paged)
                    continue
                self._waves += 1
                self._wave_kinds[kind] += 1
                for i, item in enumerate(group):
                    rid, prompt, budget = item[:3]
                    r = rows[i]
                    self._req[r] = rid
                    self._out[r] = []
                    self._budget[r] = budget
                    self._committed[r] = prompt.size
                    self._reused[rid] = self._prefix_len(kind, key, item)
                    if self._ledger is not None:
                        alloc, used = self._admission_cells(kind, key, item)
                        self._ledger.note_admission(kind, alloc, used)
                    self._usage.admitted(rid)
                    t_sub = self._submitted_at.pop(rid, None)
                    if t_sub is not None:
                        self._queue_ms[rid] = (t0 - t_sub) * 1e3
                        self._ttft_ms[rid] = (now - t_sub) * 1e3
                    finished.extend(self._take_token(r, int(toks[i])))
            stalled = stalled or self._short
            self._mark_dirty()
        return finished

    def _maybe_shed(self, item) -> bool:
        """Deadline shedding: True when `item`'s queue wait passed its
        TTFT deadline. The request is dropped (no prefill), the
        ``serving/shed_expired``, ``serving/shed_<priority>`` and
        ``serving/shed_tokens`` counters tick, its usage closes with
        outcome 'shed', its stream entry turns done and shed, and
        `was_shed` answers once."""
        rid, _prompt, budget, _pr = item
        dl = self._deadline_at.get(rid)
        if dl is None or time.perf_counter() <= dl:
            return False
        pr = self._priority.pop(rid, _admission.DEFAULT_PRIORITY)
        self._deadline_at.pop(rid, None)
        self._submitted_at.pop(rid, None)
        self._shed.add(rid)
        ent = self._stream.get(rid)
        if ent is not None:
            ent["done"] = True
            ent["shed"] = True
        reg = metrics.default_registry()
        reg.counter("serving/shed_expired").incr()
        reg.counter(f"serving/shed_{pr}").incr()
        reg.counter("serving/shed_tokens").incr(int(budget))
        self._usage.finish(rid, 0, outcome="shed")
        return True

    def _mark_dirty(self) -> None:
        """Admission invalidated the device-resident loop state."""


class ContinuousBatcher(_BatcherBase):
    """Fixed-batch continuous serving loop over a causal LM.

    model: a `models.gpt.GPT` on `device` (CUDA by default). batch_size:
    resident decode rows. max_len: per-row cache budget (prompt +
    generated must fit). scan_depth: ceiling K on decode ticks per host
    round-trip. The sampling config is fixed per batcher; temperature > 0
    draws from `generator` (a torch.Generator on `device`).

    prefix_cache: a `prefix_cache.PrefixCache` (dense) or
    `paged.PagedPrefixCache` (paged), True/'on' (the default budget), an
    int byte budget, False/'off', or None to defer to
    ``TFDE_PREFIX_CACHE``. paged: True serves from a block pool (or
    raises), False the dense slab, None defers to ``TFDE_PAGED_KV``.
    pool_blocks: the pool's size in blocks, null block included (default
    `batch_size * nmax + 1`, nmax = ceil((max_len + 1) / TFDE_KV_BLOCK));
    fewer than nmax + 1 raises. kv_quant: 'int8' stores every cache in
    int8 with fp32 scale planes, 'fp' keeps the model's own format (full
    precision by default), None defers to ``TFDE_KV_QUANT`` (fp or int8;
    any other value raises). role: 'both' (default), 'prefill' (serves
    `prime()` only: the hand-off producer of the role split) or 'decode'
    (refuses `prime()`; admits `submit_primed()` hand-offs beside plain
    submits). admission_ctl: an `admission.AdmissionController` (default:
    one from the ``TFDE_ADMIT_*`` knobs, every cap off).

    Usage::

        srv = ContinuousBatcher(model, batch_size=4, max_len=256)
        rid = srv.submit(prompt_1d, max_new_tokens=64)
        while not srv.idle:
            for req_id, tokens in srv.step():
                ...   # finished requests, completion order
    """

    def __init__(self, model, batch_size: int, max_len: int,
                 temperature: float = 0.0, top_k: Optional[int] = None,
                 top_p: Optional[float] = None,
                 min_p: Optional[float] = None,
                 repetition_penalty: float = 1.0,
                 eos_id: Optional[int] = None, pad_id: int = 0,
                 generator: Optional[torch.Generator] = None,
                 prompt_buckets: Optional[tuple] = None,
                 scan_depth: int = 4, prefix_cache=None,
                 role: str = "both", admission_ctl=None,
                 paged: Optional[bool] = None,
                 pool_blocks: Optional[int] = None,
                 kv_quant: Optional[str] = None, device=None):
        if repetition_penalty <= 0.0:
            raise ValueError(
                f"repetition_penalty must be > 0 (1.0 = off), got "
                f"{repetition_penalty}")
        if scan_depth < 1:
            raise ValueError(f"scan_depth must be >= 1, got {scan_depth}")
        # one resolution covers every cache this batcher builds: the slab
        # or pool, the wave's row caches and the trie's segments
        self._kv_quant = resolve_kv_quant(
            model, knobs.kv_quant_spec() if kv_quant is None else kv_quant)
        super().__init__(model, batch_size, max_len, eos_id, pad_id,
                         prompt_buckets, device, role=role,
                         admission_ctl=admission_ctl)
        self._sampling = dict(
            temperature=float(temperature), top_k=top_k, top_p=top_p,
            min_p=min_p, repetition_penalty=float(repetition_penalty))
        self._generator = generator
        self._scan_depth = int(scan_depth)
        self._vocab = model.vocab_size
        # presence mask for the repetition penalty (prompt ids included),
        # on the device and threaded through the decode rounds
        self._seen = (
            torch.zeros((batch_size, self._vocab), dtype=torch.bool,
                        device=self._device)
            if repetition_penalty != 1.0 else None)
        self._paged = (knobs.env_flag("TFDE_PAGED_KV") if paged is None
                       else bool(paged))
        self._defrags = 0
        if self._paged:
            block = self._kv_block = DEFAULT_BLOCK
            # +1 cell: the decode rounds write one past a frozen row's
            # committed count, so a full row still has a slot for it
            self._nmax = _paged.blocks_for(self._max_len + 1, block)
            self._chunk = min(
                max(1, knobs.env_int("TFDE_PAGED_PREFILL_CHUNK", 64)),
                self._max_len)
            nblocks = (int(pool_blocks) if pool_blocks is not None
                       else batch_size * self._nmax + 1)
            if nblocks < self._nmax + 1:
                raise ValueError(
                    f"pool_blocks={nblocks} cannot hold even one "
                    f"max-length row ({self._nmax} blocks + null)")
            self._cache = init_cache(model, batch_size, self._max_len,
                                     paged_blocks=nblocks, kv_block=block,
                                     kv_quant=self._kv_quant)
            self._pool = _paged.BlockPool(nblocks, block)
            self._tables = np.zeros((batch_size, self._nmax), np.int32)
            self._row_blocks: list = [[] for _ in range(batch_size)]
            # each row's prefix cells shared with the trie (the ledger
            # counts a shared cell once)
            self._shared_cells = np.zeros(batch_size, np.int64)
            self._tables_dirty = False
            block_bytes = _paged.pool_bytes(self._cache) / float(nblocks)
            self._prefix = _paged.resolve_paged(prefix_cache, self._pool,
                                                block_bytes)
            if self._prefix is not None:
                self._pool.set_evictor(self._prefix.evict)
        else:
            if pool_blocks is not None:
                raise ValueError("pool_blocks sizes the paged pool; pass "
                                 "paged=True with it")
            self._pool = None
            self._cache = init_cache(model, batch_size, self._max_len,
                                     kv_quant=self._kv_quant)
            self._prefix = _resolve_prefix(prefix_cache)
        self._cache.set_index(torch.zeros(batch_size, dtype=torch.int64,
                                          device=self._device))
        self._init_capacity(self._cache)
        # device-resident loop state (tok/idx/budget/done); rebuilt from
        # host bookkeeping whenever admission desyncs it
        self._dev = None

    @property
    def prefix_cache(self):
        """The prefix trie (`PrefixCache`, `PagedPrefixCache`) or None."""
        return self._prefix

    @property
    def paged(self) -> bool:
        return self._paged

    @property
    def kv_quant(self) -> Optional[str]:
        """The caches' storage format: None (full precision) or 'int8'."""
        return self._kv_quant

    @property
    def block_pool(self):
        """The paged layout's `BlockPool` (None when dense)."""
        return self._pool

    @property
    def defrag_passes(self) -> int:
        """Pool defragmentations run (paged: at capacity stalls)."""
        return self._defrags

    def stats(self) -> dict:
        """Decode ticks run, tokens delivered, tokens per round, and the
        host cost per token: dispatches and blocking syncs (the O(1/K)
        bound the K-tick rounds exist for); then the prefill waves run and
        the wall seconds spent in prefill waves and in decode rounds."""
        g = max(self._generated, 1)
        return {
            "rounds": self._rounds,
            "generated": self._generated,
            "tokens_per_round": self._generated / max(self._rounds, 1),
            "dispatches": self._dispatches,
            "syncs": self._syncs,
            "dispatches_per_token": self._dispatches / g,
            "syncs_per_token": self._syncs / g,
            "prefill_waves": self._waves,
            "prefill_s": self._prefill_s,
            "decode_s": self._decode_s,
        }

    def step(self) -> list:
        """Admit into free rows, run one decode round (up to `scan_depth`
        ticks); returns [(request_id, tokens 1-D np.int32), ...] that
        finished now. A remat-trained model serves with remat off
        (`decode.remat_off`). The ``serving/batcher/*`` and kv/* gauges
        are refreshed after every step (`_publish_stats`), as the JAX
        batcher publishes them."""
        with remat_off(self._model):
            finished = self._step()
        self._publish_stats()
        return finished

    def _step(self) -> list:
        finished = self._admit()
        active = [r for r in range(self._b) if self._req[r] is not None]
        if not active:
            return finished
        depth = self._pick_depth(active)
        t0 = time.perf_counter()
        if self._paged and self._tables_dirty:
            # a released row's device table still points at its old
            # blocks and its frozen pad writes continue every tick:
            # re-point it at the null block before any program runs
            _paged.set_block_tables(self._cache, self._tables)
            self._tables_dirty = False
            self._dispatches += 1
        if self._dev is None:
            self._upload_state()
        tok, idx, budget, done = self._dev
        out = _decode_scan(
            self._model, self._cache, tok, idx, budget, done, self._seen,
            self._generator, depth, eos_id=self._eos, pad_id=self._pad,
            **self._sampling)
        self._dispatches += 1
        tok, idx, budget, done, self._seen, toks, emitted = out
        self._dev = (tok, idx, budget, done)
        toks_np, emitted_np = _fetch((toks, emitted))
        self._syncs += 1
        self._decode_s += time.perf_counter() - t0
        self._rounds += depth
        n_emitted = 0
        for r in active:
            row = toks_np[r][emitted_np[r]]
            if row.size == 0:
                continue
            n_emitted += int(row.size)
            # feeding each pending token committed it; the row's last
            # sample stays pending
            self._committed[r] += int(row.size)
            for t in row:
                finished.extend(self._take_token(r, int(t)))
        # the drain rate: this round's tokens over its wall time, from
        # before the first program to after the host replay (JAX's span)
        self._admission.note_drain(n_emitted, time.perf_counter() - t0)
        return finished

    def _validate_submit(self, prompt, max_new_tokens) -> None:
        if self._seen is not None and (
                prompt.min() < 0 or prompt.max() >= self._vocab):
            raise ValueError(
                f"prompt ids must lie in [0, {self._vocab}) when "
                f"repetition_penalty is on; got "
                f"[{int(prompt.min())}, {int(prompt.max())}]")
        if self._paged:
            need = _paged.blocks_for(
                int(prompt.size) + int(max_new_tokens) + 1, self._kv_block)
            if need > self._pool.num_blocks - 1:
                # at submit: the capacity gate would requeue it forever
                raise ValueError(
                    f"request needs {need} KV blocks but the pool holds "
                    f"{self._pool.num_blocks - 1}; raise pool_blocks or "
                    f"shrink the request")
        super()._validate_submit(prompt, max_new_tokens)

    def _pick_depth(self, active) -> int:
        """K for this round: bound by the SOONEST row completion while the
        queue waits (a freed row admits without waiting out a long round),
        by the LONGEST remaining budget when it is empty (no dead ticks)."""
        if self._scan_depth == 1:
            return 1
        remaining = [int(self._budget[r]) for r in active]
        bound = min(remaining) if self._queue else max(remaining)
        return _ladder_depth(self._scan_depth, bound)

    def _mark_dirty(self) -> None:
        self._dev = None

    def _upload_state(self) -> None:
        """Rebuild the device loop state from host bookkeeping."""
        dev = self._device
        self._dev = (
            torch.as_tensor(self._tok, dtype=torch.int64, device=dev),
            torch.as_tensor(self._committed, dtype=torch.int64, device=dev),
            torch.as_tensor(self._budget, dtype=torch.int64, device=dev),
            torch.as_tensor(np.asarray([r is None for r in self._req]),
                            device=dev),
        )
        self._dispatches += 1  # the four small host->device transfers

    # -- dense waves (cold, warm) ---------------------------------------------
    def _first_tokens(self, row_cache, feed: np.ndarray, last: np.ndarray,
                      fullp: np.ndarray, plens: np.ndarray):
        """Run `feed` [R, S] into `row_cache` from its index, take each
        row's logits at `last` [R], and sample the first tokens with the
        presence mask of the whole padded prompts `fullp` [R, F] (their
        first `plens` tokens) when the penalty is on. Returns (tok [R],
        seen rows [R, V] or None)."""
        dev = self._device
        rp = feed.shape[0]
        ar = torch.arange(rp, device=dev)
        logits = _prefill_logits(self._model, row_cache, feed, last)
        row_seen = None
        if self._seen is not None:
            valid = torch.as_tensor(
                np.arange(fullp.shape[1])[None, :] < plens[:, None],
                device=dev)
            hits = torch.zeros((rp, self._vocab), dtype=torch.int64,
                               device=dev)
            hits.index_put_((ar[:, None], torch.as_tensor(fullp, device=dev)),
                            valid.long(), accumulate=True)
            row_seen = hits > 0
        tok = sample_logits(logits, self._generator, seen=row_seen,
                            **self._sampling)
        if row_seen is not None:
            row_seen[ar, tok] = True
        return tok, row_seen

    def _land_rows(self, row_cache, rows, n: int, tok, row_seen
                   ) -> np.ndarray:
        """Scatter a wave's row cache (and presence rows) into batch rows
        `rows` [R] and fetch the first tokens."""
        rp = len(rows)
        rows_dev = torch.as_tensor(rows, device=self._device)
        self._cache.scatter_rows(row_cache, rows_dev)
        self._dispatches += 1
        if row_seen is not None:
            if rp > n:
                # a ladder-padding row's sampled first token can differ
                # from row 0's under temperature > 0; gather duplicates
                # back to row 0 so the duplicate writes are identical
                sel = np.arange(rp)
                sel[n:] = 0
                row_seen = row_seen[torch.as_tensor(sel, device=self._device)]
            self._seen[rows_dev] = row_seen
            self._dispatches += 1
        (tok_np,) = _fetch((tok,))
        self._syncs += 1
        return tok_np

    @torch.no_grad()
    def _prefill_wave(self, prompts, last, rows, plens, n) -> np.ndarray:
        row_cache = init_cache(self._model, prompts.shape[0], self._max_len,
                               kv_quant=self._kv_quant)
        self._dispatches += 1  # the fresh zero row cache
        tok, row_seen = self._first_tokens(row_cache, prompts, last, prompts,
                                           plens)
        self._dispatches += 1
        if self._prefix is not None:
            # cold admissions seed the trie with their complete blocks
            for i in range(n):
                self._prefix.insert(prompts[i, :plens[i]], row_cache, i)
        return self._land_rows(row_cache, rows, n, tok, row_seen)

    def _plan_wave(self, wave) -> list:
        if self._paged:
            return self._plan_paged_wave(wave)
        if self._prefix is None:
            return super()._plan_wave(wave)
        cold: dict = collections.OrderedDict()
        warm: dict = collections.OrderedDict()
        primed: dict = collections.OrderedDict()
        block = self._prefix.block
        for rid, prompt, budget, pr in wave:
            bucket = next(b for b in self._buckets if b >= prompt.size)
            if pr is not None:
                primed.setdefault(bucket, []).append(
                    (rid, prompt, budget, pr, None))
                continue
            pre_len, kv = self._prefix.lookup(prompt)
            # the suffix feeds at cache position pre_len, so its bucket
            # must fit the row too (pre_len + bucket <= max_len), or the
            # clamped cache write would overwrite the prefix K/V. Shorten
            # the prefix a block at a time until a bucket fits; pre_len 0
            # is a cold admission, whose bucket always fits.
            matched, sbucket = pre_len, None
            while pre_len:
                suffix = prompt.size - pre_len
                sbucket = next(
                    (b for b in self._buckets
                     if b >= suffix and pre_len + b <= self._max_len), None)
                if sbucket is not None:
                    break
                pre_len -= block
            if pre_len:
                if pre_len < matched:
                    kv = {name: a[:pre_len] for name, a in kv.items()}
                # the full-prompt bucket shapes the wave only when the
                # penalty needs the whole prompt's presence mask
                fbucket = bucket if self._seen is not None else 0
                warm.setdefault((pre_len, sbucket, fbucket), []).append(
                    (rid, prompt, budget, None, kv))
            else:
                cold.setdefault(bucket, []).append(
                    (rid, prompt, budget, None, None))
        return ([("cold", b, g) for b, g in cold.items()]
                + [("warm", k, g) for k, g in warm.items()]
                + [("primed", b, g) for b, g in primed.items()])

    def _run_group(self, kind: str, key, group, rows) -> np.ndarray:
        if kind == "warm":
            return self._warm_wave(key, group, rows)
        if kind == "paged":
            return self._paged_wave(key, group, rows)
        return super()._run_group(kind, key, group, rows)

    def _prefix_len(self, kind: str, key, item) -> int:
        if kind == "warm":
            return int(key[0])
        if kind == "paged":
            return int(item[4][0])
        return 0

    @torch.no_grad()
    def _warm_wave(self, key, group, rows) -> np.ndarray:
        """Admit rows whose prompt prefix is cached: write the prefix K/V
        into a fresh row cache at [0, pre_len), set its index to pre_len
        and prefill ONLY the suffix (the masked einsum over the row
        cache: the index is not 0), one wave per (prefix length, suffix
        bucket, full bucket) group."""
        pre_len, sbucket, fbucket = key
        # _plan_wave guarantees the suffix bucket fits past the prefix; a
        # violation would clamp the write onto the prefix K/V
        assert pre_len + sbucket <= self._max_len, (pre_len, sbucket)
        n = len(group)
        rp = _pad_wave(n, self._b)
        suffixes = np.full((rp, sbucket), self._pad, np.int64)
        last = np.zeros(rp, np.int64)
        fullp = np.full((rp, fbucket), self._pad, np.int64)
        plens = np.zeros(rp, np.int64)
        kv_rows = []
        for i in range(rp):
            _rid, prompt, _budget, _pr, kv = group[i if i < n else 0]
            suffix = prompt[pre_len:]
            suffixes[i, :suffix.size] = suffix
            last[i] = suffix.size - 1
            if fbucket:
                fullp[i, :prompt.size] = prompt
            plens[i] = prompt.size
            kv_rows.append(kv)
        row_cache = init_cache(self._model, rp, self._max_len,
                               kv_quant=self._kv_quant)
        self._dispatches += 1  # the fresh zero row cache
        for name, slab in row_cache.planes().items():
            seg = torch.stack([kv[name] for kv in kv_rows])
            if seg.dtype != slab.dtype:
                raise ValueError(
                    f"prefix segment {name} is {seg.dtype}, this batcher's "
                    f"cache {slab.dtype}: one trie serves one cache layout")
            slab[:, :pre_len] = seg
        row_cache.set_index(int(pre_len))
        tok, row_seen = self._first_tokens(row_cache, suffixes, last, fullp,
                                           plens)
        self._dispatches += 2  # the wave's K/V stack + the suffix prefill
        rows_pad = np.asarray(rows + [rows[0]] * (rp - n), np.int64)
        return self._land_rows(row_cache, rows_pad, n, tok, row_seen)

    # -- paged KV -------------------------------------------------------------
    def _release_row(self, r: int) -> None:
        if not self._paged:
            return
        if self._row_blocks[r]:
            self._pool.free(self._row_blocks[r])
            self._row_blocks[r] = []
        self._tables[r, :] = 0
        self._shared_cells[r] = 0
        # the device table still points at the freed blocks: re-uploaded
        # before the next program (the freed-row junk-write hazard)
        self._tables_dirty = True

    def _init_capacity(self, cache) -> None:
        if not self._paged:
            return super()._init_capacity(cache)
        self._ledger = _capacity.PagedCapacityLedger(
            self._b, self._max_len, _paged.pool_bytes(cache),
            self._pool.num_blocks, self._kv_block, self._paged_snapshot,
            census=_capacity.kv_dtype_census(cache))
        self._cap_model = _capacity.PagedCapacityModel(self._ledger)

    def _paged_snapshot(self) -> dict:
        """The paged ledger's view of the pool: its stats, the trie's
        blocks and the cells rows share with the trie."""
        snap = self._pool.stats()
        snap["trie_blocks"] = (self._prefix.segments
                               if self._prefix is not None else 0)
        snap["shared_cells"] = int(self._shared_cells.sum())
        return snap

    def _admission_cells(self, kind: str, key, item) -> tuple:
        if not self._paged:
            return super()._admission_cells(kind, key, item)
        # the fresh blocks the prompt took (past the shared prefix), in
        # cells, against the prompt tokens they hold: intra-block slack
        # (a primed row shares nothing)
        prompt = item[1]
        pre = int(item[4][0]) if kind == "paged" else 0
        block = self._kv_block
        alloc = (_paged.blocks_for(int(prompt.size), block)
                 - pre // block) * block
        return alloc, int(prompt.size) - pre

    def _admission_cost(self, item) -> int:
        if not self._paged:
            return 0
        _rid, prompt, budget, _pr = item
        # the whole lifetime, sharing ignored: a warm match only lowers
        # the real claim, so the gate errs toward stalling a wave early
        return _paged.blocks_for(int(prompt.size) + int(budget) + 1,
                                 self._kv_block)

    def _admit_capacity(self, need: int, reserved: int) -> bool:
        if not self._paged:
            return True
        evictable = (self._prefix.evictable_blocks()
                     if self._prefix is not None else 0)
        if self._pool.available(evictable) >= reserved + need:
            return True
        # No row holds a block and the wave is empty: only the trie does.
        # `evictable_blocks` counts its leaves, but the allocation's
        # eviction cascades through the interior nodes too, so the
        # request fits; stalling would wait for a completion that cannot
        # come (the JAX gate loops forever here).
        return reserved == 0 and all(r is None for r in self._req)

    def _on_capacity_stall(self) -> None:
        """Admission stalled on the pool: compact it when its
        fragmentation is at or above ``TFDE_KV_DEFRAG_THRESHOLD`` (0.5; 0
        disables). Safe here: the stall comes before `_plan_paged_wave`
        claims blocks, so the only id holders are the rows' block lists,
        the trie and the host tables, all rewritten below, with the pool
        payload permuted on the device in the same step; the device
        tables are re-uploaded before the next program."""
        if not self._paged:
            return
        thr = knobs.env_float("TFDE_KV_DEFRAG_THRESHOLD", 0.5)
        if not thr or thr <= 0:
            return
        if self._pool.fragmentation() < thr:
            return
        plan = self._pool.defrag()
        if not plan:
            return
        self._tables = _paged.apply_defrag(self._cache, self._tables, plan)
        self._row_blocks = [[plan.get(int(b), int(b)) for b in row]
                            for row in self._row_blocks]
        if self._prefix is not None:
            self._prefix.remap(plan)
        self._tables_dirty = True
        self._defrags += 1
        metrics.default_registry().counter("kv/pool_defrags").incr()

    def _plan_paged_wave(self, wave) -> list:
        """Paged planning: cold and warm admissions form ONE 'paged' group
        (the chunk program does not care about prompt lengths). A warm
        lookup CLAIMS its blocks here (incref), so nothing before the
        wave, another item's allocation draining the trie included, can
        invalidate them; the claim is the row's own reference. A
        duplicate prompt in the same wave still misses: its twin's blocks
        join the trie after the wave. Primed hand-offs keep their bucket
        groups (the shipped K/V stack is shaped by the bucket)."""
        items = []
        primed: dict = collections.OrderedDict()
        for rid, prompt, budget, pr in wave:
            if pr is not None:
                bucket = next(b for b in self._buckets if b >= prompt.size)
                primed.setdefault(bucket, []).append(
                    (rid, prompt, budget, pr, None))
                continue
            pre_len, ids = 0, None
            if self._prefix is not None:
                pre_len, ids = self._prefix.lookup(prompt, claim=True)
            items.append((rid, prompt, budget, None, (pre_len, ids)))
        plans = [("paged", self._chunk, items)] if items else []
        return plans + [("primed", b, g) for b, g in primed.items()]

    def _give_back(self, items) -> None:
        """Requests of a paged wave whose blocks did not fit after all:
        their claimed trie blocks go back, the requests go back to the
        front of their lanes in order, and admission stalls. The JAX
        gate counts a trie leaf that an active row shares as evictable,
        and the JAX wave then raises PoolExhausted mid-admission."""
        if not items:
            return
        for rid, prompt, budget, pr, extra in reversed(items):
            if extra is not None and extra[1]:
                self._prefix.release(extra[1])
            self._queue.appendleft((rid, prompt, budget, pr),
                                   priority=self._priority.get(
                                       rid, _admission.DEFAULT_PRIORITY))
        self._stalls += 1
        self._short = True

    @torch.no_grad()
    def _paged_wave(self, chunk: int, group, rows) -> np.ndarray:
        """Admit a paged wave: point each row's table at its claimed trie
        blocks plus fresh blocks for the rest of its lifetime, then feed
        every suffix through one [B, chunk] program a chunk at a time.

        Rows outside the wave ride along as pad feeds at their committed
        index (their junk lands in their own uncommitted cells or the null
        block); a wave row whose suffix is done pads at its prompt's end.
        A row's first-token logits are taken from the chunk holding its
        last prompt position (`take`, at chunk-local `last_in`) into the
        [B, V] carry; the first tokens are sampled from it over the
        ladder-padded wave. Cold rows then give their complete prompt
        blocks to the trie by incref."""
        block = self._kv_block
        dev = self._device
        for i, (_rid, prompt, budget, _pr, (_pre, ids)) in enumerate(group):
            shared = [int(b) for b in ids] if ids else []
            fresh = _paged.blocks_for(prompt.size + budget + 1,
                                      block) - len(shared)
            try:
                self._row_blocks[rows[i]] = shared + self._pool.alloc(fresh)
                continue
            except _paged.PoolExhausted:
                # the later requests' claims keep shared blocks alive:
                # give those requests back, then try this one again
                self._give_back(group[i + 1:])
                del group[i + 1:]
            try:
                self._row_blocks[rows[i]] = shared + self._pool.alloc(fresh)
            except _paged.PoolExhausted:
                if i == 0 and all(self._req[r] is None
                                  for r in range(self._b)):
                    raise  # nothing will free a block: a real overflow
                self._give_back(group[i:])
                del group[i:]
                if not group:
                    return np.zeros(0, np.int64)
        n = len(group)
        starts = np.zeros(n, np.int64)
        plens = np.zeros(n, np.int64)
        for i, (_rid, prompt, _budget, _pr, (pre_len, _ids)) in enumerate(
                group):
            r = rows[i]
            held = self._row_blocks[r]
            self._tables[r, :len(held)] = held
            self._tables[r, len(held):] = 0
            self._shared_cells[r] = pre_len
            starts[i] = pre_len
            plens[i] = prompt.size
        _paged.set_block_tables(self._cache, self._tables)
        self._tables_dirty = False
        self._dispatches += 1
        nchunks = -(-int((plens - starts).max()) // chunk)
        ar = torch.arange(self._b, device=dev)
        prev = torch.zeros((self._b, self._vocab), dtype=torch.float32,
                           device=dev)
        for j in range(nchunks):
            tokens = np.full((self._b, chunk), self._pad, np.int64)
            idx = self._committed.copy()
            take = np.zeros(self._b, bool)
            last_in = np.zeros(self._b, np.int64)
            for i in range(n):
                r = rows[i]
                prompt = group[i][1]
                s = int(starts[i]) + j * chunk
                e = min(int(plens[i]), s + chunk)
                if s < plens[i]:
                    tokens[r, :e - s] = prompt[s:e]
                    idx[r] = s
                    if e == plens[i]:
                        take[r] = True
                        last_in[r] = e - 1 - s
                else:
                    idx[r] = plens[i]  # done: pads beyond its own prompt
            self._cache.set_index(torch.as_tensor(idx, device=dev))
            h = self._model.hidden(torch.as_tensor(tokens, device=dev),
                                   cache=self._cache)
            logits = self._model.head(
                h[ar, torch.as_tensor(last_in, device=dev)])
            prev = torch.where(torch.as_tensor(take, device=dev)[:, None],
                               logits, prev)
            self._dispatches += 1
        rp = _pad_wave(n, self._b)
        pick = [rows[i if i < n else 0] for i in range(rp)]
        wave_logits = prev[torch.as_tensor(pick, device=dev)]
        self._dispatches += 1
        seen = None
        if self._seen is not None:
            seen_rows = np.zeros((rp, self._vocab), bool)
            for i in range(rp):
                seen_rows[i, group[i if i < n else 0][1]] = True
            seen = torch.as_tensor(seen_rows, device=dev)
        tok = sample_logits(wave_logits, self._generator, seen=seen,
                            **self._sampling)
        self._dispatches += 1
        if seen is not None:
            seen[torch.arange(rp, device=dev), tok] = True
            if rp > n:
                # the dense duplicate-row rule: duplicate targets carry
                # identical values
                sel = np.arange(rp)
                sel[n:] = 0
                seen = seen[torch.as_tensor(sel, device=dev)]
            self._seen[torch.as_tensor(pick, device=dev)] = seen
            self._dispatches += 1
        (tok_np,) = _fetch((tok,))
        self._syncs += 1
        if self._prefix is not None:
            for i, (_rid, prompt, _budget, _pr, (pre_len, _ids)) in enumerate(
                    group):
                nb = prompt.size // block
                if pre_len == 0 and nb:  # warm rows don't re-insert
                    self._prefix.insert(prompt, self._row_blocks[rows[i]][:nb])
        return tok_np

    # -- prefill/decode role split -------------------------------------------
    _accepts_primed = True

    def _check_primed(self, primed: PrimedRequest,
                      prompt: np.ndarray) -> None:
        """The payload must be this batcher's dense layout over the
        prompt's cells: the cache's plane names and dtypes (int8 with its
        scale planes), its cell widths, P cells each (a paged batcher
        takes the same dense planes and re-chunks them to blocks)."""
        check_planes(self._cache, primed.kv, lead=1)
        for name, t in primed.kv.items():
            if t.shape[0] != prompt.size:
                raise ValueError(
                    f"shipped plane {name} holds {t.shape[0]} cells, the "
                    f"prompt {prompt.size} tokens")

    @torch.no_grad()
    def prime(self, prompt, max_new_tokens: int,
              trace=None) -> PrimedRequest:
        """Run ONLY the prefill of one request and return the hand-off for
        a decode replica's `submit_primed()`: a one-row cold prefill at the
        prompt's bucket into a fresh dense row cache (even in a paged
        batcher, as JAX does: the hand-off is layout-agnostic), through
        `_first_tokens`, so every layer's attention is the flash kernel on
        a CUDA tensor. The row's planes over the prompt's cells and the
        first token come to the host in one sync. Touches no decode row
        and no queue. A dense prefix trie is seeded with the prompt's
        blocks; a paged trie holds pool blocks, which this row has none
        of. `trace`: only None (tracing is not ported)."""
        if self._role == "decode":
            raise RuntimeError("decode-only replica cannot prime")
        _no_trace(trace)
        prompt = self._check_request(prompt, max_new_tokens)
        p = int(prompt.size)
        bucket = next(b for b in self._buckets if b >= p)
        padded = np.full((1, bucket), self._pad, np.int64)
        padded[0, :p] = prompt
        with remat_off(self._model):
            row_cache = init_cache(self._model, 1, self._max_len,
                                   kv_quant=self._kv_quant)
            self._dispatches += 1  # the fresh zero row cache
            tok, _ = self._first_tokens(row_cache, padded,
                                        np.asarray([p - 1]), padded,
                                        np.asarray([p]))
            self._dispatches += 1
        if self._prefix is not None and not self._paged:
            self._prefix.insert(prompt, row_cache, 0)
        kv, tok_np = _fetch_planes(
            {name: t[0, :p] for name, t in row_cache.planes().items()}, tok)
        self._syncs += 1
        return PrimedRequest(prompt=prompt.copy(),
                             first_token=int(tok_np[0]),
                             max_new_tokens=int(max_new_tokens), kv=kv)

    def _stack_primed(self, group, rp: int, cells: int, copy_pad: bool):
        """A primed group's shipped planes stacked on the host, [rp,
        cells, ...] each, right-padded with zeros; the first tokens [rp]
        and, with the penalty on, the presence rows [rp, V] rebuilt from
        the ids (cheaper than shipping a vocab row). Ladder padding rows
        take row 0's tokens and presence, and its payload when
        `copy_pad` (dense: duplicate row writes) or zeros (paged: writes
        to the null block)."""
        n = len(group)
        sample = group[0][3].kv
        stacked = {name: torch.zeros((rp, cells) + tuple(t.shape[1:]),
                                     dtype=t.dtype)
                   for name, t in sample.items()}
        toks = np.zeros(rp, np.int64)
        seen = (np.zeros((rp, self._vocab), bool)
                if self._seen is not None else None)
        for i in range(rp):
            _rid, prompt, _budget, pr, _x = group[i if i < n else 0]
            if i < n or copy_pad:
                for name, t in pr.kv.items():
                    stacked[name][i, :t.shape[0]] = t
            toks[i] = pr.first_token
            if seen is not None:
                seen[i, prompt] = True
                seen[i, pr.first_token] = True
        return stacked, toks, seen

    @torch.no_grad()
    def _primed_wave(self, bucket: int, group, rows) -> np.ndarray:
        """Admit rows primed on another replica: stack the shipped planes
        right-padded to the bucket, one scatter into the slab rows, the
        presence rows rebuilt from the ids. No model FLOPs and no sync:
        the first tokens are already on the host."""
        if self._paged:
            return self._primed_paged_wave(bucket, group, rows)
        dev = self._device
        n = len(group)
        rp = _pad_wave(n, self._b)
        rows_dev = torch.as_tensor(rows + [rows[0]] * (rp - n), device=dev)
        stacked, toks, seen = self._stack_primed(group, rp, bucket,
                                                 copy_pad=True)
        self._cache.land_planes(
            {name: t.to(dev) for name, t in stacked.items()}, rows_dev)
        self._dispatches += 1
        if seen is not None:
            self._seen[rows_dev] = torch.as_tensor(seen, device=dev)
            self._dispatches += 1
        return toks

    @torch.no_grad()
    def _primed_paged_wave(self, bucket: int, group, rows) -> np.ndarray:
        """The primed hand-off under paging: allocate each row's lifetime
        blocks (a request that does not fit goes back to the front of its
        lane, as in `_paged_wave`), point the tables at them, re-chunk the
        shipped planes to blocks and land them with one scatter into the
        pools. Padding rows and the slots past a row's prompt blocks name
        the null block and carry zeros."""
        block = self._kv_block
        dev = self._device
        for i, (_rid, prompt, budget, _pr, _x) in enumerate(group):
            try:
                self._row_blocks[rows[i]] = self._pool.alloc(
                    _paged.blocks_for(prompt.size + budget + 1, block))
            except _paged.PoolExhausted:
                if i == 0 and all(self._req[r] is None
                                  for r in range(self._b)):
                    raise  # nothing will free a block: a real overflow
                self._give_back(group[i:])
                del group[i:]
                if not group:
                    return np.zeros(0, np.int64)
                break
        n = len(group)
        rp = _pad_wave(n, self._b)
        nb_bucket = _paged.blocks_for(bucket, block)
        blk = np.zeros((rp, nb_bucket), np.int64)
        for i in range(n):
            r = rows[i]
            held = self._row_blocks[r]
            self._tables[r, :len(held)] = held
            self._tables[r, len(held):] = 0
            self._shared_cells[r] = 0
            nbp = _paged.blocks_for(group[i][1].size, block)
            blk[i, :nbp] = held[:nbp]
        stacked, toks, seen = self._stack_primed(
            group, rp, nb_bucket * block, copy_pad=False)
        _paged.set_block_tables(self._cache, self._tables)
        self._tables_dirty = False
        self._dispatches += 1
        self._cache.land_blocks(
            {name: t.reshape((rp, nb_bucket, block) + tuple(t.shape[2:]))
             .to(dev) for name, t in stacked.items()},
            torch.as_tensor(blk, device=dev))
        self._dispatches += 1
        if seen is not None:
            rows_dev = torch.as_tensor(rows[:n] + [rows[0]] * (rp - n),
                                       device=dev)
            self._seen[rows_dev] = torch.as_tensor(seen, device=dev)
            self._dispatches += 1
        return toks


class SpeculativeContinuousBatcher(_BatcherBase):
    """Continuous batching accelerated by a draft model: every round the
    draft proposes `num_draft` tokens a row and ONE target forward
    verifies them all (inference/speculative.py's round, per-row
    acceptance), while freed rows admit queued requests between rounds in
    bucketed waves, as `ContinuousBatcher` does.

    model, draft_model: `models.gpt.GPT`s of one vocabulary on `device`
    (CUDA by default). The target and draft slabs hold max_len +
    num_draft + 1 cells a row (a round feeds num_draft + 1 tokens past a
    row's committed count before the rewind); the KV ledger tracks the
    target slab (the draft cache is a cost of speculation, not serving
    capacity). temperature 0 (default): each request's tokens equal its
    solo greedy `generate`; temperature > 0: speculative sampling, drawn
    from `generator`. Admission control (`admission_ctl`, default the
    ``TFDE_ADMIT_*`` knobs), priorities and deadlines come from the base.
    As in JAX there is no prefix cache, paged pool, int8 KV argument or
    role: such an argument is a TypeError, the ``TFDE_PREFIX_CACHE``,
    ``TFDE_PAGED_KV`` and ``TFDE_KV_QUANT`` knobs are not read (the slabs
    take the models' own KV format), and `submit_primed` raises. `stats()`
    reports rounds, tokens, tokens a round a row, the draft's acceptance
    rate, dispatches and syncs; the ``serving/speculative/*`` gauges
    mirror it after every step, and each round observes
    ``serving/ms_per_token`` and feeds the admission drain rate."""

    _metrics_prefix = "serving/speculative"

    def __init__(self, model, draft_model, batch_size: int, max_len: int,
                 num_draft: int = 4, temperature: float = 0.0,
                 eos_id: Optional[int] = None, pad_id: int = 0,
                 generator: Optional[torch.Generator] = None,
                 prompt_buckets: Optional[tuple] = None,
                 admission_ctl=None, device=None):
        if num_draft < 1:
            raise ValueError(f"num_draft must be >= 1, got {num_draft}")
        super().__init__(model, batch_size, max_len, eos_id, pad_id,
                         prompt_buckets, device, admission_ctl=admission_ctl)
        if draft_model.device != self._device:
            raise ValueError(f"draft model is on {draft_model.device}, the "
                             f"batcher was asked for {self._device}")
        self._draft = draft_model
        self._temperature = float(temperature)
        self._generator = generator
        self._nd = int(num_draft)
        self._cache_len = self._max_len + self._nd + 1
        self._tgt_cache = init_cache(model, batch_size, self._cache_len)
        self._drf_cache = init_cache(draft_model, batch_size,
                                     self._cache_len)
        self._init_capacity(self._tgt_cache, cells_per_row=self._cache_len)
        self._round_tokens = 0    # tokens the rounds produced
        self._draft_proposed = 0  # num_draft a row a round
        self._draft_accepted = 0  # commits beyond the guaranteed token

    def stats(self) -> dict:
        """Rounds, tokens delivered, tokens a round a ROW (1.0: no draft
        ever accepted; num_draft + 1: a perfect draft), the share of
        proposed draft tokens committed, and the host cost in the JAX
        units (dispatches, syncs)."""
        return {
            "rounds": self._rounds,
            "generated": self._generated,
            "tokens_per_round": (self._round_tokens
                                 / max(self._rounds * self._b, 1)),
            "acceptance_rate": (self._draft_accepted
                                / max(self._draft_proposed, 1)),
            "dispatches": self._dispatches,
            "syncs": self._syncs,
        }

    def _validate_submit(self, prompt, max_new_tokens) -> None:
        super()._validate_submit(prompt, max_new_tokens)
        validate_budget(self._draft, int(prompt.size), max_new_tokens)

    @torch.no_grad()
    def _prefill_wave(self, prompts, last, rows, plens, n) -> np.ndarray:
        """Both prefills of one cold wave on fresh row caches at index 0
        (the flash kernel on a CUDA tensor), the target's first tokens
        sampled at each row's true last position (the draft's head does
        not run), then one scatter a cache and one fetch."""
        rp = prompts.shape[0]
        tgt_rows = init_cache(self._model, rp, self._cache_len)
        drf_rows = init_cache(self._draft, rp, self._cache_len)
        self._dispatches += 2  # the two fresh zero row caches
        logits = _prefill_logits(self._model, tgt_rows, prompts, last)
        tok = sample_logits(logits, self._generator,
                            temperature=self._temperature)
        self._draft.hidden(torch.as_tensor(prompts, device=self._device),
                           cache=drf_rows)
        self._dispatches += 2
        rows_dev = torch.as_tensor(rows, device=self._device)
        self._tgt_cache.scatter_rows(tgt_rows, rows_dev)
        self._drf_cache.scatter_rows(drf_rows, rows_dev)
        self._dispatches += 2
        (tok_np,) = _fetch((tok,))
        self._syncs += 1
        return tok_np

    def step(self) -> list:
        """Admit, then run ONE speculative round for the whole batch;
        returns [(request_id, tokens 1-D np.int32), ...] that finished on
        it. Remat-trained models serve with remat off."""
        with remat_off(self._model), remat_off(self._draft):
            finished = self._step()
        self._publish_stats()
        return finished

    @torch.no_grad()
    def _step(self) -> list:
        finished = self._admit()
        active = [r for r in range(self._b) if self._req[r] is not None]
        if not active:
            return finished
        self._rounds += 1
        t0 = time.perf_counter()
        # the rewind each round: acceptance lengths diverge every round
        for cache in (self._tgt_cache, self._drf_cache):
            cache.set_index(torch.as_tensor(self._committed,
                                            device=self._device))
        self._dispatches += 2
        round_toks, n_new, _ = run_round(
            self._model, self._draft, self._tgt_cache, self._drf_cache,
            torch.as_tensor(self._tok, device=self._device), self._nd,
            self._pad, self._temperature, self._generator)
        self._dispatches += 1
        round_np, n_np = fetch_round(round_toks, n_new)
        self._syncs += 1
        n_emitted = 0
        for r in active:
            taken = 0
            for t in round_np[r, :int(n_np[r])].tolist():
                if self._req[r] is None:
                    break  # the row finished mid-round: overshoot dropped
                self._round_tokens += 1
                finished.extend(self._take_token(r, int(t)))
                taken += 1
            n_emitted += taken
            # a row's commits beyond the target's own token are accepted
            # proposals (the (num_draft + 1)-th is the bonus, no draft's)
            self._draft_proposed += self._nd
            self._draft_accepted += min(max(taken - 1, 0), self._nd)
            if self._req[r] is not None:
                # tok_last and the accepted tokens are now in both caches
                # (the pending one stays unfed)
                self._committed[r] += taken
        dt = time.perf_counter() - t0
        self._decode_s += dt
        if n_emitted:
            metrics.default_registry().histogram(
                "serving/ms_per_token").observe(dt * 1e3 / n_emitted)
            self._admission.note_drain(n_emitted, dt)
        return finished
