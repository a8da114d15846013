"""KV-capacity observability: occupancy ledger, headroom model, usage
meter — a copy of `tfde_tpu/observability/capacity.py`, adapted to the
port's caches (the port never imports the JAX package).

- **CapacityLedger** — the occupancy picture, one subclass per cache
  layout. The dense base reports the per-row slab: the batcher feeds
  committed cells (the true per-row index) per decode round and
  pad-ladder allocation per admission wave; the ledger publishes the
  ``kv/{allocated_bytes,used_bytes,waste_frac,rows_active,rows_free}``
  gauges plus per-bucket pad-waste counters and a unit-interval waste
  histogram. The per-cell cost is derived from the slab's own bytes
  (`kv_slab_bytes`: int8 payload and fp32 scale planes both count), so
  ``kv/used_bytes`` equals the bytes of the live cache cells.
  `PagedCapacityLedger` re-bases the same gauges on the block pool
  (``TFDE_PAGED_KV``): allocated bytes are the blocks actually held, so
  ``kv/waste_frac`` is intra-block slack, and the ``kv/pool_blocks_*``
  gauges split the pool into active/trie/free.
- **CapacityModel** — headroom: memory budget (``TFDE_CAPACITY_BUDGET_
  BYTES``, 0 = slab-derived) folded with the measured per-row cost into
  ``kv/headroom_rows`` / ``kv/headroom_tokens`` (the admission gate of
  the JAX batcher reads them; not ported yet).
- **UsageMeter** — per-request prompt tokens, generated tokens, and
  KV-residency (token·seconds of slab occupancy), stamped with the
  priority class and outcome, counted under ``usage/*`` and appended to a
  bounded JSONL log (``TFDE_USAGE_LOG``).

`kv_slab_bytes` and `kv_dtype_census` walk the port's `KVCache` planes
(`decode.KVCache.planes()`: payloads and scale planes; the index and a
paged block table are not planes) where JAX walks a flax cache tree.
The knobs raise on a value they cannot read (`knobs.env_count`) where
the JAX readers warn and fall back.

Thread-safety: the ledger and meter are written from the batcher's step
loop but may be read from other threads, so each carries its own lock.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, Optional

from tfde_tpu_torch import knobs
from tfde_tpu_torch.observability import metrics

#: unit-interval buckets for pad-waste fractions — the default registry
#: ladder is a seconds scale and would collapse every observation into
#: its first bucket
WASTE_BUCKETS = (0.05, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9,
                 0.95, 1.0)

DEFAULT_USAGE_LOG_BYTES = 8 * 1024 * 1024


def _nbytes(t) -> int:
    return int(t.numel() * t.element_size())


def kv_slab_bytes(cache) -> int:
    """Total K/V bytes of a batcher cache (`KVCache.planes()`: payloads
    and int8 scale planes): the ledger's allocated-bytes baseline AND the
    denominator of its per-cell cost model."""
    return sum(_nbytes(t) for t in cache.planes().values())


def kv_dtype_census(cache) -> dict:
    """Dtype split of a KV cache: payload vs scale-plane bytes, the
    payload dtype (numpy's name: 'float32', 'bfloat16', 'int8'), and the
    fp32-equivalent payload cost — what the same cells would occupy
    unquantized at fp32. An fp cache has no scale planes, so its split is
    all payload."""
    payload = scale = payload_elems = 0
    dtype = None
    bits = 0
    for (_layer, name), t in cache.planes().items():
        if name.endswith("_scale"):
            scale += _nbytes(t)
        else:
            payload += _nbytes(t)
            payload_elems += int(t.numel())
            dtype = str(t.dtype).removeprefix("torch.")
            bits = int(t.element_size()) * 8
    return {
        "kv_dtype": dtype or "none",
        "kv_quant_bits": bits if dtype else 0,
        "kv_payload_bytes": payload,
        "kv_scale_bytes": scale,
        "kv_fp32_equiv_bytes": payload_elems * 4,
    }


class CapacityLedger:
    """Dense-slab KV occupancy and pad-ladder waste accounting.

    One ledger per batcher cache. `observe` is fed the host-side
    committed counts every decode round / stats publish;
    `note_admission` is fed every admitted request's (bucket, true
    prompt length) at wave time. All shared state under `_lock`.
    """

    def __init__(self, batch_size: int, cells_per_row: int,
                 slab_bytes: int,
                 registry: Optional[metrics.Registry] = None,
                 census: Optional[dict] = None):
        if batch_size < 1 or cells_per_row < 1:
            raise ValueError(
                f"need batch_size/cells_per_row >= 1, got "
                f"{batch_size}/{cells_per_row}"
            )
        self._lock = threading.Lock()
        self._b = int(batch_size)
        self._cells = int(cells_per_row)
        self._slab_bytes = int(slab_bytes)
        #: dtype split of the slab (kv_dtype_census) — prices the
        #: quantized-vs-fp delta; empty when the caller passes none
        self._census = dict(census or {})
        #: measured per-cell cost: the slab's own bytes over its cells,
        #: so used_bytes sums exactly to the slab when every row is full
        self._cell_bytes = self._slab_bytes / float(self._b * self._cells)
        self._reg = registry or metrics.default_registry()
        self._used_cells = 0
        self._rows_active = 0
        self._pad_alloc_tokens = 0
        self._pad_waste_tokens = 0
        self._bucket_alloc: Dict[int, int] = {}
        self._bucket_waste: Dict[int, int] = {}

    @classmethod
    def from_cache(cls, cache, batch_size: int, cells_per_row: int,
                   registry: Optional[metrics.Registry] = None
                   ) -> "CapacityLedger":
        """Build a ledger from a freshly-initialized dense slab."""
        return cls(batch_size, cells_per_row, kv_slab_bytes(cache),
                   registry=registry, census=kv_dtype_census(cache))

    # -- read surface --------------------------------------------------------
    @property
    def cell_bytes(self) -> float:
        return self._cell_bytes

    @property
    def row_bytes(self) -> float:
        """Per-row slab cost — the headroom model's admission unit."""
        return self._cell_bytes * self._cells

    @property
    def slab_bytes(self) -> int:
        return self._slab_bytes

    @property
    def cells_per_row(self) -> int:
        return self._cells

    @property
    def census(self) -> dict:
        """The slab/pool dtype split (kv_dtype_census); {} when unknown."""
        return dict(self._census)

    def _publish_census(self) -> dict:
        """Gauge + stats-dict surface of the dtype split (the dtype string
        itself rides the `kv_stats()` dict; kv/quant_bits is its numeric
        twin for metrics-snapshot readers)."""
        if not self._census:
            return {}
        g = self._reg.gauge
        g("kv/quant_bits").set(self._census.get("kv_quant_bits", 0))
        g("kv/payload_bytes").set(self._census.get("kv_payload_bytes", 0))
        g("kv/scale_bytes").set(self._census.get("kv_scale_bytes", 0))
        g("kv/fp32_equiv_bytes").set(
            self._census.get("kv_fp32_equiv_bytes", 0))
        return dict(self._census)

    # -- the per-round report ------------------------------------------------
    def observe(self, committed, req) -> dict:
        """Fold one host-bookkeeping snapshot (`committed` [B] counts,
        `req` [B] request-id-or-None) into the occupancy gauges; returns
        the stats dict (`ContinuousBatcher.kv_stats()`)."""
        used = 0
        active = 0
        for r in range(self._b):
            if req[r] is not None:
                active += 1
                used += int(committed[r])
        with self._lock:
            self._used_cells = used
            self._rows_active = active
        used_bytes = used * self._cell_bytes
        waste = 1.0 - used / float(self._b * self._cells)
        g = self._reg.gauge
        g("kv/allocated_bytes").set(self._slab_bytes)
        g("kv/used_bytes").set(used_bytes)
        g("kv/waste_frac").set(waste)
        g("kv/rows_active").set(active)
        g("kv/rows_free").set(self._b - active)
        out = {
            "allocated_bytes": self._slab_bytes,
            "used_bytes": used_bytes,
            "used_cells": used,
            "waste_frac": waste,
            "rows_active": active,
            "rows_free": self._b - active,
        }
        out.update(self._publish_census())
        return out

    # -- the per-wave report -------------------------------------------------
    def note_admission(self, kind: str, bucket: int, used_tokens: int
                       ) -> None:
        """One admitted request's pad-ladder cost: `bucket` cells were
        computed/written (the prefill program's shape), `used_tokens` of
        them are real prompt (or suffix) — the rest is the pad waste the
        paged layout reclaims. Counted per bucket, so the worst
        pad-ladder cell can be named."""
        bucket = int(bucket)
        used = min(int(used_tokens), bucket)
        waste = bucket - used
        with self._lock:
            self._pad_alloc_tokens += bucket
            self._pad_waste_tokens += waste
            self._bucket_alloc[bucket] = (
                self._bucket_alloc.get(bucket, 0) + bucket)
            self._bucket_waste[bucket] = (
                self._bucket_waste.get(bucket, 0) + waste)
        c = self._reg.counter
        c("kv/pad_alloc_tokens").incr(bucket)
        if waste:
            c("kv/pad_waste_tokens").incr(waste)
        c(f"kv/pad_alloc_tokens/bucket_{bucket}").incr(bucket)
        c(f"kv/pad_waste_tokens/bucket_{bucket}").incr(waste)
        self._reg.histogram(
            "kv/pad_waste_frac", buckets=WASTE_BUCKETS
        ).observe(waste / bucket if bucket else 0.0)

    def pad_stats(self) -> dict:
        """Cumulative pad-ladder accounting."""
        with self._lock:
            return {
                "pad_alloc_tokens": self._pad_alloc_tokens,
                "pad_waste_tokens": self._pad_waste_tokens,
                "per_bucket": {
                    b: {"alloc": self._bucket_alloc[b],
                        "waste": self._bucket_waste.get(b, 0)}
                    for b in sorted(self._bucket_alloc)
                },
            }


class PagedCapacityLedger(CapacityLedger):
    """Block-pool KV occupancy (``TFDE_PAGED_KV``).

    The dense ledger's denominator is the whole pre-carved slab, so
    ``kv/waste_frac`` charges every cell a short request never touches.
    Under paging a row only holds the blocks it was granted, so the
    honest denominator is the blocks ACTUALLY HELD (active rows + trie)
    and the remaining waste is intra-block slack plus not-yet-decoded
    lifetime blocks. `snapshot` is a duck-typed callable
    (observability never imports inference) returning::

        {"total": .., "free": .., "active": ..,   # BlockPool.stats()
         "trie_blocks": ..,                        # trie-held (refs)
         "shared_cells": ..}                       # sum over rows of
                                                   # trie-shared pre_len

    ``used_bytes`` counts each resident token once: row-committed cells
    minus the trie-shared cells they'd double-count, plus the trie's own
    blocks. A block the trie evicted while a row still holds it is
    undercounted by that row's shared cells — waste reads slightly high,
    never low. Inherits `note_admission` (fed fresh-block cells per
    admission, so the pad-waste histogram measures intra-block slack)
    and the dense lock discipline.
    """

    def __init__(self, batch_size: int, cells_per_row: int,
                 pool_bytes: int, num_blocks: int, block: int,
                 snapshot,
                 registry: Optional[metrics.Registry] = None,
                 census: Optional[dict] = None):
        super().__init__(batch_size, cells_per_row, pool_bytes,
                         registry=registry, census=census)
        if num_blocks < 2 or block < 1:
            raise ValueError(
                f"need num_blocks >= 2 and block >= 1, got "
                f"{num_blocks}/{block}"
            )
        self._block = int(block)
        self._blocks_total = int(num_blocks) - 1  # null block excluded
        # per-cell cost re-based on the POOL's geometry (the null block
        # included in the denominator: it is real allocated HBM)
        self._cell_bytes = pool_bytes / float(num_blocks * block)
        self._snapshot = snapshot

    @property
    def block(self) -> int:
        return self._block

    @property
    def block_bytes(self) -> float:
        return self._cell_bytes * self._block

    @property
    def row_bytes(self) -> float:
        """Worst-case per-row cost: a full block table — the headroom
        model's conservative admission unit."""
        blocks_per_row = -(-self._cells // self._block)
        return self.block_bytes * blocks_per_row

    def observe(self, committed, req) -> dict:
        used = 0
        active = 0
        for r in range(self._b):
            if req[r] is not None:
                active += 1
                used += int(committed[r])
        snap = self._snapshot()
        trie_blocks = int(snap.get("trie_blocks", 0))
        shared = int(snap.get("shared_cells", 0))
        held = int(snap["active"])  # rows + trie, refcount-deduped
        free = int(snap["free"])
        used_cells = max(used - shared, 0) + trie_blocks * self._block
        with self._lock:
            self._used_cells = used_cells
            self._rows_active = active
        allocated = held * self.block_bytes
        used_bytes = used_cells * self._cell_bytes
        waste = (1.0 - used_bytes / allocated) if allocated else 0.0
        g = self._reg.gauge
        g("kv/allocated_bytes").set(allocated)
        g("kv/used_bytes").set(used_bytes)
        g("kv/waste_frac").set(waste)
        g("kv/rows_active").set(active)
        g("kv/rows_free").set(self._b - active)
        g("kv/pool_blocks_total").set(self._blocks_total)
        g("kv/pool_blocks_free").set(free)
        g("kv/pool_blocks_active").set(held - trie_blocks)
        g("kv/pool_blocks_trie").set(trie_blocks)
        out = {
            "allocated_bytes": allocated,
            "used_bytes": used_bytes,
            "used_cells": used_cells,
            "waste_frac": waste,
            "rows_active": active,
            "rows_free": self._b - active,
            "pool_blocks_total": self._blocks_total,
            "pool_blocks_free": free,
            "pool_blocks_active": held - trie_blocks,
            "pool_blocks_trie": trie_blocks,
        }
        out.update(self._publish_census())
        return out


class CapacityModel:
    """Headroom: how many more rows/tokens fit before the memory budget.

    budget_bytes = 0 (the default, ``TFDE_CAPACITY_BUDGET_BYTES``)
    derives capacity from the dense slab itself: the slab is
    pre-allocated, so headroom is simply the free rows (and their
    cells). A positive budget models a tighter external constraint —
    the forced-low-budget drill, or a real HBM envelope shared with the
    params — and headroom_rows is what still fits under it at the
    ledger's measured per-row cost.
    """

    def __init__(self, ledger: CapacityLedger,
                 budget_bytes: Optional[int] = None,
                 registry: Optional[metrics.Registry] = None):
        if budget_bytes is None:
            budget_bytes = knobs.env_count("TFDE_CAPACITY_BUDGET_BYTES", 0)
        self._ledger = ledger
        self.budget_bytes = int(budget_bytes or 0)
        self._reg = registry or metrics.default_registry()

    def headroom(self, occ: dict) -> dict:
        """Headroom rows/tokens for an `observe()` stats dict; publishes
        the kv/headroom_* gauges and returns the two fields (merged into
        `kv_stats()`)."""
        rows_free = int(occ["rows_free"])
        if self.budget_bytes <= 0:
            rows = rows_free
            tokens = rows_free * self._ledger.cells_per_row
        else:
            spare = self.budget_bytes - float(occ["used_bytes"])
            rows = min(rows_free,
                       max(0, int(spare // self._ledger.row_bytes)))
            tokens = min(rows_free * self._ledger.cells_per_row,
                         max(0, int(spare // self._ledger.cell_bytes)))
        g = self._reg.gauge
        g("kv/headroom_rows").set(rows)
        g("kv/headroom_tokens").set(tokens)
        return {"headroom_rows": rows, "headroom_tokens": tokens}


class PagedCapacityModel(CapacityModel):
    """Headroom over a block pool: the admission currency is BLOCKS.

    With no byte budget, what fits is whatever the free list (plus
    nothing — trie slack is the admission gate's business) can grant:
    ``headroom_tokens`` is the free blocks' cells and ``headroom_rows``
    conservatively prices a row at a full block table (the worst case a
    request may claim; the actual per-request block gate lives in the
    batcher's `_admit_capacity`). A positive ``TFDE_CAPACITY_BUDGET_
    BYTES`` first caps the grantable blocks at what the budget buys —
    the same-envelope dense-vs-paged comparison.
    """

    def headroom(self, occ: dict) -> dict:
        ledger = self._ledger
        rows_free = int(occ["rows_free"])
        free_blocks = int(occ.get("pool_blocks_free", 0))
        if self.budget_bytes > 0:
            held = int(occ.get("pool_blocks_active", 0)
                       + occ.get("pool_blocks_trie", 0))
            affordable = int(self.budget_bytes // ledger.block_bytes)
            free_blocks = min(free_blocks, max(0, affordable - held))
        blocks_per_row = -(-ledger.cells_per_row // ledger.block)
        rows = min(rows_free, free_blocks // blocks_per_row)
        tokens = free_blocks * ledger.block
        g = self._reg.gauge
        g("kv/headroom_rows").set(rows)
        g("kv/headroom_tokens").set(tokens)
        return {"headroom_rows": rows, "headroom_tokens": tokens}


# -- usage metering -----------------------------------------------------------
class UsageLog:
    """Bounded append-only JSONL usage log.

    One line per finished request. The byte bound (``TFDE_CAPACITY_
    USAGE_LOG_BYTES``) is enforced by compaction: when an append would
    overflow, the oldest lines are dropped until the newest half of the
    bound remains — so the file never grows past the bound and always
    holds the most recent records. Local paths only; all shared state
    under `_lock`.
    """

    def __init__(self, path: str, max_bytes: Optional[int] = None):
        if max_bytes is None:
            max_bytes = knobs.env_count("TFDE_CAPACITY_USAGE_LOG_BYTES",
                                        DEFAULT_USAGE_LOG_BYTES)
        self._lock = threading.Lock()
        self.path = str(path)
        self.max_bytes = int(max_bytes or DEFAULT_USAGE_LOG_BYTES)
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        with self._lock:
            self._f = open(self.path, "a")
            self._bytes = self._f.tell()

    def write(self, rec: dict) -> None:
        line = json.dumps(rec, sort_keys=True) + "\n"
        with self._lock:
            if self._f is None:
                return
            if self._bytes + len(line) > self.max_bytes:
                self._compact_locked(len(line))
            self._f.write(line)
            self._f.flush()
            self._bytes += len(line)

    def _compact_locked(self, incoming: int) -> None:
        """Drop oldest lines until newest `max_bytes // 2` (minus the
        incoming line) remain. Called with the lock held."""
        self._f.close()
        keep_budget = max(self.max_bytes // 2 - incoming, 0)
        with open(self.path) as f:
            lines = f.readlines()
        kept: list = []
        size = 0
        for line in reversed(lines):
            if size + len(line) > keep_budget:
                break
            kept.append(line)
            size += len(line)
        kept.reverse()
        with open(self.path, "w") as f:
            f.writelines(kept)
        self._f = open(self.path, "a")
        self._bytes = size

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None


def _host_id() -> int:
    """This process's rank for the log's file name: the cluster contract
    (``TFDE_PROCESS_ID``, then ``TASK_INDEX``), else 0."""
    try:
        return int(os.environ.get("TFDE_PROCESS_ID")
                   or os.environ.get("TASK_INDEX") or 0)
    except ValueError:
        return 0


def resolve_usage_log(model_dir: Optional[str] = None
                      ) -> Optional[UsageLog]:
    """Normalize ``TFDE_USAGE_LOG``: unset/``off`` -> None; ``on`` ->
    ``<model_dir>/metrics/usage_<host>.jsonl`` (None when no model_dir
    to anchor it — `arm(model_dir)` re-arms later);
    anything else is an explicit path."""
    spec = (knobs.env_str("TFDE_USAGE_LOG") or "").strip()
    if spec.lower() in ("", "off", "0", "false", "no"):
        return None
    if spec.lower() in ("on", "1", "true", "yes"):
        if model_dir is None:
            return None
        return UsageLog(os.path.join(
            model_dir, "metrics", f"usage_{_host_id()}.jsonl"))
    return UsageLog(spec)


class UsageMeter:
    """Per-request usage accounting: prompt/generated tokens and
    KV-residency token·seconds, stamped with priority and outcome.

    Residency integrates slab occupancy over the request's resident
    window [admit, finish] with the trapezoid of its token count
    (prompt at admit, prompt+generated at finish) — the billing-grade
    capacity-cost unit. Requests finished before admission (queue-side
    shed/cancel) occupied no slab and meter zero residency. All shared
    state under `_lock`.
    """

    def __init__(self, registry: Optional[metrics.Registry] = None,
                 log: Optional[UsageLog] = None):
        self._lock = threading.Lock()
        self._reg = registry or metrics.default_registry()
        self._log = log if log is not None else resolve_usage_log(None)
        self._open: Dict[int, dict] = {}
        self._totals = {"requests": 0, "prompt_tokens": 0,
                        "generated_tokens": 0, "kv_token_seconds": 0.0}

    def arm(self, model_dir: Optional[str]) -> None:
        """Late-bind the JSONL log once a model_dir exists (the
        batcher's `arm_usage_log`). First successful arm wins."""
        log = resolve_usage_log(model_dir)
        with self._lock:
            if self._log is None:
                self._log = log
            elif log is not None:
                log.close()

    @property
    def log_path(self) -> Optional[str]:
        with self._lock:
            return self._log.path if self._log is not None else None

    def begin(self, rid: int, prompt_tokens: int, priority: str) -> None:
        rec = {"rid": int(rid), "prompt_tokens": int(prompt_tokens),
               "priority": str(priority),
               "t_submit": time.perf_counter(), "t_admit": None}
        with self._lock:
            self._open[int(rid)] = rec

    def admitted(self, rid: int) -> None:
        now = time.perf_counter()
        with self._lock:
            rec = self._open.get(int(rid))
            if rec is not None and rec["t_admit"] is None:
                rec["t_admit"] = now

    def finish(self, rid: int, generated_tokens: int,
               outcome: str = "ok") -> Optional[dict]:
        """Close one request's meter; idempotent (an unknown/already-
        closed rid is a no-op). Returns the usage record."""
        now = time.perf_counter()
        with self._lock:
            rec = self._open.pop(int(rid), None)
        if rec is None:
            return None
        prompt = int(rec["prompt_tokens"])
        gen = int(generated_tokens)
        t_admit = rec["t_admit"]
        resident_s = (now - t_admit) if t_admit is not None else 0.0
        # trapezoid: prompt cells at admit, prompt+generated at finish
        residency = (prompt + (prompt + gen)) / 2.0 * resident_s
        out = {
            "ts": time.time(),
            "rid": int(rid),
            "priority": rec["priority"],
            "outcome": str(outcome),
            "prompt_tokens": prompt,
            "generated_tokens": gen,
            "kv_token_seconds": round(residency, 6),
            "queue_wait_s": round(
                (t_admit - rec["t_submit"])
                if t_admit is not None else now - rec["t_submit"], 6),
            "resident_s": round(resident_s, 6),
        }
        with self._lock:
            self._totals["requests"] += 1
            self._totals["prompt_tokens"] += prompt
            self._totals["generated_tokens"] += gen
            self._totals["kv_token_seconds"] += residency
            log = self._log
        c = self._reg.counter
        c("usage/requests").incr()
        c(f"usage/requests/{rec['priority']}").incr()
        c(f"usage/requests/{outcome}").incr()
        c("usage/prompt_tokens").incr(prompt)
        c("usage/generated_tokens").incr(gen)
        c("usage/kv_token_seconds").incr(residency)
        if log is not None:
            log.write(out)
        return out

    def totals(self) -> dict:
        """Cumulative sums across finished requests (the bit-exactness
        pin: prompt/generated totals equal the per-request emissions)."""
        with self._lock:
            return dict(self._totals)

    def close(self) -> None:
        with self._lock:
            log, self._log = self._log, None
        if log is not None:
            log.close()
