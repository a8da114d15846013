"""Paged KV — counterpart of `tfde_tpu/inference/paged.py`.

The dense serving cache gives every row `max_len` cells up front, and the
prefix trie keeps a second copy of every cached prefix. Paged KV replaces
both with one block-granular pool:

- `BlockPool`: the host allocator for the physical pool the paged cache
  holds (`decode.PagedKVCache`: [num_blocks, block, Kv, D] a layer and
  k/v). Blocks are refcounted, so one block can back the trie and any
  number of rows at once; block 0 is the pinned null block (unallocated
  table slots point there, junk writes land there). The free list is
  guarded by `_lock`, as in JAX (the step loop writes while another
  thread may read `stats()`).
- `PagedPrefixCache`: the trie re-pointed at the pool. Nodes hold block
  IDS: a warm admission points the row's table at the matched blocks and
  increfs them (no copy), a cold admission's complete prompt blocks join
  the trie by incref. Eviction (LRU childless leaves, op-stamp
  protected: the dense trie's policy) decrefs back to the pool, and the
  pool calls it when allocation starves: one LRU over cached prefixes
  and free space.
- `set_block_tables`: host tables -> the cache's device table.

Safety invariants (shared with `MultiHeadAttention._paged_attention`):
- the trie holds only COMPLETE prompt blocks, and a warm row's first
  write position (its block-aligned prefix length) opens a private block:
  shared blocks are never written after insertion;
- junk writes (pad feeds of frozen or not-admitted rows) land beyond the
  writer's committed count: in its own allocated cells (overwritten
  position-exactly before a mask reaches them) or in the null block;
- a freed row's table points at the null block BEFORE its next program
  runs, so its frozen pad writes never hit a reallocated block.
"""

from __future__ import annotations

import threading
from typing import Callable, List, Optional

import numpy as np
import torch

from tfde_tpu_torch import knobs
from tfde_tpu_torch.inference.prefix_cache import (
    DEFAULT_BYTE_BUDGET,
    block_key,
    lru_leaf,
    match,
    publish_stats,
    stats_dict,
)
from tfde_tpu_torch.observability import trace as _trace

#: the null block: unallocated table slots point here, out-of-range writes
#: are routed here; never allocated, never read through a mask
NULL_BLOCK = 0


def blocks_for(tokens: int, block: int) -> int:
    """Pool blocks covering `tokens` cells (ceil division)."""
    return -(-int(tokens) // int(block))


def set_block_tables(cache, tables) -> None:
    """Copy host `tables` ([B, nmax] ints) into the paged cache's device
    table, in place."""
    cache.table.copy_(torch.as_tensor(np.asarray(tables), dtype=torch.int64))


def pool_bytes(cache) -> int:
    """Pool K/V bytes of a paged cache, the int8 scale pools included (the
    table and index excluded)."""
    return sum(t.numel() * t.element_size() for t in cache.planes().values())


class PoolExhausted(RuntimeError):
    """Allocation could not be satisfied even after trie eviction; the
    admission gate exists to make this unreachable."""


class BlockPool:
    """Refcounted free-list allocator over the physical KV pool.

    IDs are ints in [1, num_blocks) (0 is the null block). `alloc` takes
    from the free list lowest id first, calling the registered evictor
    (the paged trie) when it starves. All shared state is under `_lock`;
    the evictor runs OUTSIDE it (it frees blocks back through `free`,
    which takes the lock itself)."""

    def __init__(self, num_blocks: int, block: int):
        if num_blocks < 2:
            raise ValueError(
                f"num_blocks must be >= 2 (block 0 is the pinned null "
                f"block), got {num_blocks}")
        if block < 1:
            raise ValueError(f"block must be >= 1, got {block}")
        self._lock = threading.Lock()
        self._n = int(num_blocks)
        self._block = int(block)
        self._ref = np.zeros(self._n, np.int64)
        self._ref[NULL_BLOCK] = 1          # pinned forever
        self._free: List[int] = list(range(self._n - 1, 0, -1))  # pop -> 1
        self._evictor: Optional[Callable[[int], int]] = None

    @property
    def num_blocks(self) -> int:
        return self._n

    @property
    def block(self) -> int:
        return self._block

    @property
    def free_blocks(self) -> int:
        with self._lock:
            return len(self._free)

    def refcount(self, bid: int) -> int:
        with self._lock:
            return int(self._ref[bid])

    def stats(self) -> dict:
        with self._lock:
            free = len(self._free)
        return {"total": self._n - 1, "free": free,
                "active": self._n - 1 - free, "block": self._block}

    def set_evictor(self, fn: Optional[Callable[[int], int]]) -> None:
        """`fn(need_blocks) -> freed`, called unlocked when `alloc`
        starves."""
        with self._lock:
            self._evictor = fn

    def available(self, evictable: int = 0) -> int:
        """Blocks an allocation could obtain now: the free list plus what
        the evictor could reclaim (admission's capacity gate)."""
        with self._lock:
            return len(self._free) + int(evictable)

    def alloc(self, n: int) -> List[int]:
        """Take `n` blocks (refcount 1 each). Starvation drains the
        evictor; still short raises PoolExhausted with everything rolled
        back. The JAX pool calls the evictor once; an evicted trie
        reference frees no block while a row shares it, so the port asks
        again while the evictor drops references (the same blocks
        wherever one call suffices)."""
        if n <= 0:
            return []
        got = self._take(n)
        while len(got) < n and self._evictor is not None:
            if not self._evictor(n - len(got)):
                break
            got += self._take(n - len(got))
        if len(got) < n:
            self.free(got)
            raise PoolExhausted(
                f"need {n} KV blocks, pool has {len(got)} even after "
                f"eviction (size the pool or gate admission)")
        return got

    def incref(self, ids) -> None:
        """Share already-allocated blocks (warm admission, trie insert)."""
        with self._lock:
            for b in ids:
                if self._ref[b] < 1:
                    raise ValueError(f"incref of unallocated block {b}")
                self._ref[b] += 1

    def free(self, ids) -> None:
        """Drop one reference per id; a block at refcount 0 returns to the
        free list."""
        with self._lock:
            for b in ids:
                b = int(b)
                if b == NULL_BLOCK:
                    raise ValueError("the null block is pinned")
                if self._ref[b] < 1:
                    raise ValueError(f"double free of block {b}")
                self._ref[b] -= 1
                if self._ref[b] == 0:
                    self._free.append(b)

    def _take(self, n: int) -> List[int]:
        with self._lock:
            self._free.sort(reverse=True)   # deterministic lowest-first
            got = []
            while self._free and len(got) < n:
                b = self._free.pop()
                self._ref[b] = 1
                got.append(b)
            return got

    def fragmentation(self) -> float:
        """Holes over the occupied span of live ids: 1 - live/max(live)
        (0.0 when compact or empty): how far the live set has drifted up
        the id space, the stall defrag's trigger
        (TFDE_KV_DEFRAG_THRESHOLD)."""
        with self._lock:
            live = [b for b in range(1, self._n) if self._ref[b] > 0]
            if not live:
                return 0.0
            return 1.0 - len(live) / float(max(live))

    def defrag(self) -> dict:
        """Compact live blocks to the lowest ids; returns {old: new} for
        every moved block and rewrites the refcounts and the free list.
        The caller applies the plan to the device pool and every block
        table (`apply_defrag`), and the trie (`PagedPrefixCache.remap`),
        before the next program runs."""
        with self._lock:
            live = sorted(int(b) for b in range(1, self._n)
                          if self._ref[b] > 0)
            plan = {}
            nxt = 1
            for b in live:
                if b != nxt:
                    plan[b] = nxt
                nxt += 1
            if plan:
                ref = np.zeros_like(self._ref)
                ref[NULL_BLOCK] = 1
                for b in live:
                    ref[plan.get(b, b)] = self._ref[b]
                self._ref = ref
                self._free = list(range(self._n - 1, nxt - 1, -1))
            return plan


def apply_defrag(cache, tables: np.ndarray, plan: dict) -> np.ndarray:
    """Apply a `BlockPool.defrag` plan: permute every pool's rows into
    their new ids on the device, in place, and return the remapped host
    tables. The int8 scale pools ride the same block ids as their
    payload and move with it. One gather a pool (a maintenance action,
    not a hot path)."""
    if not plan:
        return tables
    perm = np.arange(cache.keys[0].shape[0])  # new id -> the old id it takes
    for old, new in plan.items():
        perm[new] = old
    perm = torch.as_tensor(perm, device=cache.keys[0].device)
    for pool in cache.planes().values():
        pool.copy_(pool[perm])
    return np.asarray([[plan.get(int(b), int(b)) for b in row]
                       for row in tables], np.int32)


class _Node:
    """One block of one cached prefix path (an ID, not a segment)."""

    __slots__ = ("key", "parent", "children", "bid", "last_used", "op")

    def __init__(self, key, parent, bid: int):
        self.key = key
        self.parent = parent
        self.children: dict = {}
        self.bid = bid
        self.last_used = 0
        self.op = 0


class PagedPrefixCache:
    """The prefix trie re-pointed at the block pool.

    The dense trie's token blocks, LRU policy, op-stamp protection and
    stats, but a node holds a pool block ID on which the trie has ONE
    reference: lookup hands matched IDs to warm admission, insert adopts
    a cold row's written blocks by incref, eviction decrefs. Registered as
    the pool's evictor. Only the batcher's step loop touches it (the
    pool's lock covers reads from other threads)."""

    def __init__(self, pool: BlockPool, block_bytes: float,
                 byte_budget: int = DEFAULT_BYTE_BUDGET):
        if byte_budget < 1:
            raise ValueError(f"byte_budget must be >= 1, got {byte_budget}")
        self._pool = pool
        self._block = pool.block
        self._block_bytes = float(block_bytes)
        self._budget = int(byte_budget)
        self._root = _Node(None, None, NULL_BLOCK)
        self._segments = 0
        self._clock = 0
        self._op = 0
        self._hits = 0
        self._misses = 0
        self._reused_tokens = 0
        self._bytes_saved = 0
        self._evictions = 0

    @property
    def pool(self) -> BlockPool:
        return self._pool

    @property
    def block(self) -> int:
        return self._block

    @property
    def byte_budget(self) -> int:
        return self._budget

    @property
    def resident_bytes(self) -> int:
        return int(self._segments * self._block_bytes)

    @property
    def segments(self) -> int:
        return self._segments

    def stats(self) -> dict:
        return stats_dict(self._hits, self._misses, self._reused_tokens,
                          self.resident_bytes, self._bytes_saved,
                          self._segments, self._evictions)

    def lookup(self, tokens, trace: Optional[str] = None,
               claim: bool = False):
        """Longest cached prefix usable for prompt `tokens`: ``(L, [block
        ids])`` (L a block multiple, >= 1 suffix token left) or ``(0,
        None)``. `claim=True` increfs the matched blocks for the caller
        (warm admission's table reference), so no eviction between plan
        and wave can invalidate them; the caller owns one `pool.free` a
        claimed block (`release`). `trace`: the request's trace id
        (``serve/prefix_lookup`` on its timeline)."""
        tokens = np.asarray(tokens).reshape(-1)
        self._op += 1
        segs = match(self._root, tokens, self._block)
        if not segs:
            self._misses += 1
            self._publish()
            if trace is not None:
                _trace.event("serve/prefix_lookup", trace=trace,
                             hit=False, reused_tokens=0)
            return 0, None
        for s in segs:
            self._clock += 1
            s.last_used = self._clock
            s.op = self._op
        ids = [s.bid for s in segs]
        if claim:
            self._pool.incref(ids)
        n = len(segs)
        self._hits += 1
        self._reused_tokens += n * self._block
        self._bytes_saved += int(n * self._block_bytes)
        self._publish()
        if trace is not None:
            _trace.event("serve/prefix_lookup", trace=trace, hit=True,
                         reused_tokens=n * self._block,
                         prompt_tokens=int(tokens.size))
        return n * self._block, ids

    def release(self, ids) -> None:
        """Undo a claim."""
        self._pool.free(ids)

    def insert(self, tokens, block_ids) -> int:
        """Adopt the complete blocks of `tokens` whose K/V live in
        `block_ids` (the admitting row's table prefix, written this wave):
        each new node increfs its block, the trie's own reference.
        Returns NEW blocks adopted; resident prefixes are LRU-touched only
        (the row keeps its private duplicate). Budget overruns evict
        LRU-first; an unevictable overflow stops the walk."""
        tokens = np.asarray(tokens).reshape(-1)
        nb = min(int(tokens.size) // self._block, len(block_ids))
        if nb == 0:
            return 0
        self._op += 1
        node, created = self._root, 0
        for b in range(nb):
            key = block_key(tokens, b, self._block)
            child = node.children.get(key)
            if child is None:
                if ((self._segments + 1) * self._block_bytes > self._budget
                        and not self._evict_blocks(1)):
                    break
                bid = int(block_ids[b])
                self._pool.incref([bid])
                child = _Node(key, node, bid)
                node.children[key] = child
                self._segments += 1
                created += 1
            self._clock += 1
            child.last_used = self._clock
            child.op = self._op
            node = child
        self._publish()
        return created

    def remap(self, plan: dict) -> int:
        """Follow a `BlockPool.defrag` plan: rewrite every node whose
        block moved. Returns nodes remapped."""
        if not plan:
            return 0
        moved = 0
        stack = list(self._root.children.values())
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            new = plan.get(node.bid)
            if new is not None:
                node.bid = new
                moved += 1
        return moved

    def evictable_blocks(self) -> int:
        """Childless segments outside the current operation: what `evict`
        could reclaim now (the admission gate's slack term)."""
        count = 0
        stack = list(self._root.children.values())
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            if not node.children and node.op != self._op:
                count += 1
        return count

    def evict(self, need_blocks: int) -> int:
        """Drop >= `need_blocks` trie references LRU-first (childless,
        op-stamp protected); returns references dropped. A block reaches
        the free list only once every row sharing it has released it."""
        return self._evict_blocks(need_blocks)

    def _evict_blocks(self, need: int) -> int:
        freed = 0
        while freed < need:
            victim = lru_leaf(self._root, self._op)
            if victim is None:
                break
            del victim.parent.children[victim.key]
            self._pool.free([victim.bid])
            victim.bid = NULL_BLOCK
            freed += 1
            self._segments -= 1
            self._evictions += 1
        if freed:
            self._publish()
        return freed

    def _publish(self) -> None:
        """The gauges (`prefix_cache.publish_stats`), counted in blocks."""
        ref = evictable = 0
        stack = list(self._root.children.values())
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            if node.op == self._op:
                ref += 1
            elif not node.children:
                evictable += 1
        publish_stats(self.stats(),
                      ref / self._segments if self._segments else 0.0,
                      int(evictable * self._block_bytes))


def resolve_paged(spec, pool: BlockPool, block_bytes: float
                  ) -> Optional[PagedPrefixCache]:
    """`prefix_cache.resolve` for paged mode: the same spec, but the
    trie shares `pool` instead of holding segments. A dense `PrefixCache`
    is refused: its segments cannot back block tables."""
    if spec is None:
        spec = knobs.prefix_cache_spec()
        if spec is None:
            return None
    if isinstance(spec, PagedPrefixCache):
        if spec.pool is not pool:
            raise ValueError("prefix_cache instance was built over a "
                             "different BlockPool than this batcher's")
        return spec
    if spec in (False, 0, "off"):
        return None
    if spec in (True, "on"):
        return PagedPrefixCache(pool, block_bytes)
    if isinstance(spec, int):
        return PagedPrefixCache(pool, block_bytes, byte_budget=spec)
    raise ValueError(
        f"unrecognized prefix_cache spec for paged mode: {spec!r} (a dense "
        f"PrefixCache cannot back block tables)")
