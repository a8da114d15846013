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

`stats()` counts dispatches and syncs in the JAX batcher's units: one per
device program the JAX batcher would run (row template, prefill, scatter,
seen update, state upload, block-table upload, prefill chunk, decode
round) and one per blocking fetch.

Not ported yet (ROADMAP queue 1 item 5): int8 KV (`kv_quant`), the
prefill/decode role split and primed hand-off (`role`, `prime`,
`submit_primed`), admission control (`admission_ctl`) and the capacity
ledger, spans/trace/flight recorder, and the speculative batcher. The
arguments and methods the JAX batcher has for them raise here.
"""

from __future__ import annotations

import collections
import time
from typing import Optional

import numpy as np
import torch

from tfde_tpu_torch import knobs
from tfde_tpu_torch.inference import paged as _paged
from tfde_tpu_torch.inference.decode import (
    KVCache,
    init_cache,
    remat_off,
    sample_logits,
    validate_budget,
)
from tfde_tpu_torch.inference.prefix_cache import (
    DEFAULT_BLOCK,
    resolve as _resolve_prefix,
)
from tfde_tpu_torch.utils.devices import resolve_device

#: priority classes, highest first — index order IS drain order
#: (tfde_tpu/inference/admission.py)
PRIORITIES = ("interactive", "batch", "best_effort")
DEFAULT_PRIORITY = "interactive"


def _fetch(tensors):
    """THE host sync: one blocking device->host copy per round."""
    return [t.cpu().numpy() for t in tensors]


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
    """One FIFO lane per priority class, drained highest-priority-first."""

    def __init__(self):
        self._lanes = collections.OrderedDict(
            (p, collections.deque()) for p in PRIORITIES)

    def append(self, item, priority: str = DEFAULT_PRIORITY) -> None:
        self._lanes[priority].append(item)

    def appendleft(self, item, priority: str = DEFAULT_PRIORITY) -> None:
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

    def __len__(self) -> int:
        return sum(len(lane) for lane in self._lanes.values())

    def __bool__(self) -> bool:
        return any(self._lanes.values())




class _BatcherBase:
    """The request queue, per-row host bookkeeping (`_take_token`),
    `cancel`, and wave admission (`_admit` plans groups with `_plan_wave`
    and runs each with `_run_group`; the subclass supplies the waves and
    the capacity hooks)."""

    def __init__(self, model, batch_size: int, max_len: int, eos_id,
                 pad_id: int, prompt_buckets, device):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
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
        self._req = [None] * batch_size          # request id or None
        self._out = [[] for _ in range(batch_size)]
        self._budget = np.zeros(batch_size, np.int64)
        self._committed = np.zeros(batch_size, np.int64)
        self._tok = np.full(batch_size, pad_id, np.int64)
        # queue items: (rid, prompt [P] np.int64, budget)
        self._queue = _PriorityDeque()
        self._priority: dict = {}
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

    @property
    def idle(self) -> bool:
        return not self._queue and all(r is None for r in self._req)

    @property
    def free_rows(self) -> int:
        return sum(r is None for r in self._req)

    def ttft_ms(self) -> dict:
        """{request id: ms from submit to its first token} so far."""
        return dict(self._ttft_ms)

    def queue_ms(self) -> dict:
        """{request id: ms from submit to the start of its admission
        wave} so far: the part of its TTFT spent waiting for a row."""
        return dict(self._queue_ms)

    def reused_tokens(self) -> dict:
        """{request id: prompt tokens its admission took from the prefix
        cache} so far (0: a cold admission)."""
        return dict(self._reused)

    def wave_counts(self) -> dict:
        """Prefill waves run, by kind: 'cold' (a dense bucket prefill,
        the flash kernel's wave), 'warm' (a dense suffix prefill after a
        prefix hit), 'paged' (the chunked paged prefill)."""
        return dict(self._wave_kinds)

    @property
    def capacity_stalls(self) -> int:
        """Times admission held a request back because its cache blocks
        did not fit (paged only)."""
        return self._stalls

    def submit(self, prompt, max_new_tokens: int,
               priority: Optional[str] = None) -> int:
        """Queue a request; returns its id. prompt: 1-D int token ids.
        priority: 'interactive' (default) > 'batch' > 'best_effort'."""
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
        pr = DEFAULT_PRIORITY if priority is None else priority
        if pr not in PRIORITIES:
            raise ValueError(f"priority must be one of {PRIORITIES}, got "
                             f"{priority!r}")
        self._validate_submit(prompt, max_new_tokens)
        rid = self._next_id
        self._next_id += 1
        self._queue.append((rid, prompt, int(max_new_tokens)), priority=pr)
        self._priority[rid] = pr
        self._submitted_at[rid] = time.perf_counter()
        return rid

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
        is discarded. Returns whether the request was found in flight."""
        self._submitted_at.pop(rid, None)
        self._priority.pop(rid, None)
        if self._queue.remove_rid(rid):
            return True
        for r in range(self._b):
            if self._req[r] == rid:
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

    def _validate_submit(self, prompt: np.ndarray,
                         max_new_tokens: int) -> None:
        validate_budget(self._model, int(prompt.size), max_new_tokens)

    def _prefill_wave(self, prompts: np.ndarray, last: np.ndarray,
                      rows: np.ndarray, plens: np.ndarray,
                      n: int) -> np.ndarray:
        """Prefill + scatter one padded wave; returns the [R] first
        tokens. Rows past `n` are ladder padding (duplicates of row 0)."""
        raise NotImplementedError

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

    def _take_token(self, r: int, t: int) -> list:
        """Record a sampled token for row r; frees the row on completion."""
        self._out[r].append(t)
        self._budget[r] -= 1
        self._tok[r] = t
        self._generated += 1
        if self._budget[r] <= 0 or (self._eos is not None and t == self._eos):
            rid = self._req[r]
            done = (rid, np.asarray(self._out[r], np.int32))
            self._priority.pop(rid, None)
            self._release_row(r)
            self._req[r] = None
            self._out[r] = []
            self._committed[r] = 0
            self._tok[r] = self._pad
            return [done]
        return []

    def _plan_wave(self, wave) -> list:
        """Group one admission wave into prefill groups: [(kind, key,
        items)], items (rid, prompt, budget, extra). Here 'cold' groups by
        prompt bucket; the batcher adds 'warm' and 'paged'."""
        groups: dict = collections.OrderedDict()
        for rid, prompt, budget in wave:
            bucket = next(b for b in self._buckets if b >= prompt.size)
            groups.setdefault(bucket, []).append((rid, prompt, budget, None))
        return [("cold", b, g) for b, g in groups.items()]

    def _run_group(self, kind: str, key, group, rows) -> np.ndarray:
        if kind == "cold":
            return self._cold_wave(key, group, rows)
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
        A request whose cache blocks do not fit goes back to the front of
        its lane, and admission stops until a completion frees blocks
        (head of line, on purpose: skipping ahead would starve big
        requests)."""
        finished = []
        stalled = False
        while self._queue and self.free_rows and not stalled:
            free = [r for r in range(self._b) if self._req[r] is None]
            wave = []
            reserved = 0
            self._short = False
            while self._queue and len(wave) < len(free):
                item = self._queue.popleft()
                need = self._admission_cost(item)
                if need and not self._admit_capacity(need, reserved):
                    self._queue.appendleft(
                        item, priority=self._priority.get(
                            item[0], DEFAULT_PRIORITY))
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
                    rid, prompt, budget, _extra = item
                    r = rows[i]
                    self._req[r] = rid
                    self._out[r] = []
                    self._budget[r] = budget
                    self._committed[r] = prompt.size
                    self._reused[rid] = self._prefix_len(kind, key, item)
                    t_sub = self._submitted_at.pop(rid, None)
                    if t_sub is not None:
                        self._queue_ms[rid] = (t0 - t_sub) * 1e3
                        self._ttft_ms[rid] = (now - t_sub) * 1e3
                    finished.extend(self._take_token(r, int(toks[i])))
            stalled = stalled or self._short
            self._mark_dirty()
        return finished

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
    fewer than nmax + 1 raises. role, admission_ctl and kv_quant are the
    JAX batcher's and are not ported: anything but their defaults
    raises.

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
        if role != "both":
            raise NotImplementedError(
                f"role={role!r}: the prefill/decode role split is not "
                f"ported (ROADMAP queue 1 item 5)")
        if admission_ctl is not None:
            raise NotImplementedError(
                "admission_ctl: admission control is not ported (ROADMAP "
                "queue 1 item 5)")
        kvq = (knobs.env_str("TFDE_KV_QUANT", "fp") if kv_quant is None
               else str(kv_quant))
        if kvq.strip().lower() != "fp":
            raise NotImplementedError(
                f"kv_quant={kvq!r} (or TFDE_KV_QUANT): int8 KV is not "
                f"ported (ROADMAP queue 1 item 5)")
        super().__init__(model, batch_size, max_len, eos_id, pad_id,
                         prompt_buckets, device)
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
                                     paged_blocks=nblocks, kv_block=block)
            self._pool = _paged.BlockPool(nblocks, block)
            self._tables = np.zeros((batch_size, self._nmax), np.int32)
            self._row_blocks: list = [[] for _ in range(batch_size)]
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
            self._cache = init_cache(model, batch_size, self._max_len)
            self._prefix = _resolve_prefix(prefix_cache)
        self._cache.set_index(torch.zeros(batch_size, dtype=torch.int64,
                                          device=self._device))
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
    def block_pool(self):
        """The paged layout's `BlockPool` (None when dense)."""
        return self._pool

    @property
    def defrag_passes(self) -> int:
        """Pool defragmentations run (paged: at capacity stalls)."""
        return self._defrags

    def prime(self, *args, **kwargs):
        raise NotImplementedError(
            "prime: the prefill/decode role split is not ported (ROADMAP "
            "queue 1 item 5)")

    def submit_primed(self, *args, **kwargs):
        raise NotImplementedError(
            "submit_primed: the prefill/decode role split is not ported "
            "(ROADMAP queue 1 item 5)")

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
        (`decode.remat_off`)."""
        with remat_off(self._model):
            return self._step()

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
        for r in active:
            row = toks_np[r][emitted_np[r]]
            if row.size == 0:
                continue
            # feeding each pending token committed it; the row's last
            # sample stays pending
            self._committed[r] += int(row.size)
            for t in row:
                finished.extend(self._take_token(r, int(t)))
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
        h = self._model.hidden(torch.as_tensor(feed, device=dev),
                               cache=row_cache)
        # the head runs on each row's true last position only
        logits = self._model.head(h[ar, torch.as_tensor(last, device=dev)])
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
        row_cache = init_cache(self._model, prompts.shape[0], self._max_len)
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
        block = self._prefix.block
        for rid, prompt, budget in wave:
            bucket = next(b for b in self._buckets if b >= prompt.size)
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
                    (rid, prompt, budget, kv))
            else:
                cold.setdefault(bucket, []).append((rid, prompt, budget, None))
        return ([("cold", b, g) for b, g in cold.items()]
                + [("warm", k, g) for k, g in warm.items()])

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
            return int(item[3][0])
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
            _rid, prompt, _budget, kv = group[i if i < n else 0]
            suffix = prompt[pre_len:]
            suffixes[i, :suffix.size] = suffix
            last[i] = suffix.size - 1
            if fbucket:
                fullp[i, :prompt.size] = prompt
            plens[i] = prompt.size
            kv_rows.append(kv)
        row_cache = init_cache(self._model, rp, self._max_len)
        self._dispatches += 1  # the fresh zero row cache
        for layer in range(len(row_cache.keys)):
            for name, slab in (("k", row_cache.keys[layer]),
                               ("v", row_cache.values[layer])):
                slab[:, :pre_len] = torch.stack(
                    [kv[(layer, name)] for kv in kv_rows]).to(slab.dtype)
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
        # the device table still points at the freed blocks: re-uploaded
        # before the next program (the freed-row junk-write hazard)
        self._tables_dirty = True

    def _admission_cost(self, item) -> int:
        if not self._paged:
            return 0
        _rid, prompt, budget = item
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

    def _plan_paged_wave(self, wave) -> list:
        """Paged planning: cold and warm admissions form ONE 'paged' group
        (the chunk program does not care about prompt lengths). A warm
        lookup CLAIMS its blocks here (incref), so nothing before the
        wave, another item's allocation draining the trie included, can
        invalidate them; the claim is the row's own reference. A
        duplicate prompt in the same wave still misses: its twin's blocks
        join the trie after the wave."""
        items = []
        for rid, prompt, budget in wave:
            pre_len, ids = 0, None
            if self._prefix is not None:
                pre_len, ids = self._prefix.lookup(prompt, claim=True)
            items.append((rid, prompt, budget, (pre_len, ids)))
        return [("paged", self._chunk, items)] if items else []

    def _give_back(self, items) -> None:
        """Requests of a paged wave whose blocks did not fit after all:
        their claimed trie blocks go back, the requests go back to the
        front of their lanes in order, and admission stalls. The JAX
        gate counts a trie leaf that an active row shares as evictable,
        and the JAX wave then raises PoolExhausted mid-admission."""
        if not items:
            return
        for rid, prompt, budget, (_pre, ids) in reversed(items):
            if ids:
                self._prefix.release(ids)
            self._queue.appendleft((rid, prompt, budget),
                                   priority=self._priority.get(
                                       rid, DEFAULT_PRIORITY))
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
        for i, (_rid, prompt, budget, (_pre, ids)) in enumerate(group):
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
        for i, (_rid, prompt, _budget, (pre_len, _ids)) in enumerate(group):
            r = rows[i]
            held = self._row_blocks[r]
            self._tables[r, :len(held)] = held
            self._tables[r, len(held):] = 0
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
            for i, (_rid, prompt, _budget, (pre_len, _ids)) in enumerate(
                    group):
                nb = prompt.size // block
                if pre_len == 0 and nb:  # warm rows don't re-insert
                    self._prefix.insert(prompt, self._row_blocks[rows[i]][:nb])
        return tok_np
