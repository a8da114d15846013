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

`stats()` counts dispatches and syncs in the JAX batcher's units: one per
device program the JAX batcher would run (row template, prefill, scatter,
seen update, state upload, decode round) and one per blocking fetch.

Not ported yet (ROADMAP): the prefix cache, paged and int8 KV, the
prefill/decode role split and primed hand-off, admission control and the
capacity ledger, spans/trace/flight recorder, cancel, and the speculative
batcher.
"""

from __future__ import annotations

import collections
import time
from typing import Optional

import numpy as np
import torch

from tfde_tpu_torch.inference.decode import (
    KVCache,
    init_cache,
    remat_off,
    sample_logits,
    validate_budget,
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
    """The request queue, per-row host bookkeeping (`_take_token`) and
    bucketed wave admission (`_admit` drives the subclass
    `_prefill_wave`)."""

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
        self._submitted_at: dict = {}
        self._ttft_ms: dict = {}
        self._next_id = 0
        self._rounds = 0       # decode ticks run
        self._generated = 0    # every delivered token (incl. prefill 1st)
        self._dispatches = 0   # device programs in the JAX batcher's units
        self._syncs = 0        # blocking device->host fetches
        self._waves = 0        # prefill waves run
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
        self._submitted_at[rid] = time.perf_counter()
        return rid

    def run(self) -> list:
        """Step until idle; returns every completion in finish order."""
        done = []
        while not self.idle:
            done.extend(self.step())
        return done

    def _validate_submit(self, prompt: np.ndarray,
                         max_new_tokens: int) -> None:
        validate_budget(self._model, int(prompt.size), max_new_tokens)

    def _prefill_wave(self, prompts: np.ndarray, last: np.ndarray,
                      rows: np.ndarray, plens: np.ndarray,
                      n: int) -> np.ndarray:
        """Prefill + scatter one padded wave; returns the [R] first
        tokens. Rows past `n` are ladder padding (duplicates of row 0)."""
        raise NotImplementedError

    def _take_token(self, r: int, t: int) -> list:
        """Record a sampled token for row r; frees the row on completion."""
        self._out[r].append(t)
        self._budget[r] -= 1
        self._tok[r] = t
        self._generated += 1
        if self._budget[r] <= 0 or (self._eos is not None and t == self._eos):
            rid = self._req[r]
            done = (rid, np.asarray(self._out[r], np.int32))
            self._req[r] = None
            self._out[r] = []
            self._committed[r] = 0
            self._tok[r] = self._pad
            return [done]
        return []

    def _plan_wave(self, wave) -> list:
        """Group one admission wave by prompt bucket: [(bucket, items)]."""
        groups: dict = collections.OrderedDict()
        for item in wave:
            bucket = next(b for b in self._buckets if b >= item[1].size)
            groups.setdefault(bucket, []).append(item)
        return list(groups.items())

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
            _rid, prompt, _budget = group[i if i < n else 0]
            prompts[i, :prompt.size] = prompt
            last[i] = prompt.size - 1
            plens[i] = prompt.size
        self._waves += 1
        t0 = time.perf_counter()
        toks = self._prefill_wave(prompts, last, rows_pad, plens, n)
        self._prefill_s += time.perf_counter() - t0  # ends in a fetch
        return toks

    def _admit(self) -> list:
        """Fill free rows from the queue a bucket wave at a time. Every
        admitted row holds one pending token afterwards; a request that
        finishes on its first token frees its row within the same call."""
        finished = []
        while self._queue and self.free_rows:
            free = [r for r in range(self._b) if self._req[r] is None]
            wave = []
            while self._queue and len(wave) < len(free):
                wave.append(self._queue.popleft())
            taken = 0
            for bucket, group in self._plan_wave(wave):
                n = len(group)
                rows = free[taken:taken + n]
                taken += n
                toks = self._cold_wave(bucket, group, rows)
                now = time.perf_counter()
                for i, (rid, prompt, budget) in enumerate(group):
                    r = rows[i]
                    self._req[r] = rid
                    self._out[r] = []
                    self._budget[r] = budget
                    self._committed[r] = prompt.size
                    t0 = self._submitted_at.pop(rid, None)
                    if t0 is not None:
                        self._ttft_ms[rid] = (now - t0) * 1e3
                    finished.extend(self._take_token(r, int(toks[i])))
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
                 scan_depth: int = 4, device=None):
        if repetition_penalty <= 0.0:
            raise ValueError(
                f"repetition_penalty must be > 0 (1.0 = off), got "
                f"{repetition_penalty}")
        if scan_depth < 1:
            raise ValueError(f"scan_depth must be >= 1, got {scan_depth}")
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
        self._cache = init_cache(model, batch_size, self._max_len)
        self._cache.set_index(torch.zeros(batch_size, dtype=torch.int64,
                                          device=self._device))
        # device-resident loop state (tok/idx/budget/done); rebuilt from
        # host bookkeeping whenever admission desyncs it
        self._dev = None

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

    @torch.no_grad()
    def _prefill_wave(self, prompts, last, rows, plens, n) -> np.ndarray:
        rp, bucket = prompts.shape
        dev = self._device
        row_cache = init_cache(self._model, rp, self._max_len)
        self._dispatches += 1  # the fresh zero row cache
        prompts_dev = torch.as_tensor(prompts, device=dev)
        ar = torch.arange(rp, device=dev)
        h = self._model.hidden(prompts_dev, cache=row_cache)
        # the first-token logits at each row's true last position (the
        # head runs on those rows only)
        logits = self._model.head(h[ar, torch.as_tensor(last, device=dev)])
        row_seen = None
        if self._seen is not None:
            valid = torch.as_tensor(
                np.arange(bucket)[None, :] < plens[:, None], device=dev)
            hits = torch.zeros((rp, self._vocab), dtype=torch.int64,
                               device=dev)
            hits.index_put_((ar[:, None], prompts_dev), valid.long(),
                            accumulate=True)
            row_seen = hits > 0
        tok = sample_logits(logits, self._generator, seen=row_seen,
                            **self._sampling)
        if row_seen is not None:
            row_seen[ar, tok] = True
        self._dispatches += 1
        rows_dev = torch.as_tensor(rows, device=dev)
        self._cache.scatter_rows(row_cache, rows_dev)
        self._dispatches += 1
        if row_seen is not None:
            if rp > n:
                # a ladder-padding row's sampled first token can differ
                # from row 0's under temperature > 0; gather duplicates
                # back to row 0 so the duplicate writes are identical
                sel = np.arange(rp)
                sel[n:] = 0
                row_seen = row_seen[torch.as_tensor(sel, device=dev)]
            self._seen[rows_dev] = row_seen
            self._dispatches += 1
        (tok_np,) = _fetch((tok,))
        self._syncs += 1
        return tok_np
