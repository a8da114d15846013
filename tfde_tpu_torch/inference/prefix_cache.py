"""Prefix-KV cache — counterpart of `tfde_tpu/inference/prefix_cache.py`.

Shared prompt prefixes (a system prompt, a few-shot preamble, a
conversation re-sent turn by turn) prefill once per replica: a token TRIE
over BLOCK-sized prompt chunks whose nodes hold the K/V segment of their
block, `[block, Kv, D]` per layer and per k/v, on the model's device. On
admission the batcher walks the trie for the longest cached prefix,
writes those segments into the fresh row cache and prefills only the
suffix (`ContinuousBatcher._warm_wave`).

- A prefix is usable in whole blocks only, and always leaves one suffix
  token: the first-token logits come from a real forward.
- A segment is a copy of the row slice `keys[layer][row, b*block:(b+1)*
  block]` of a prefill's row cache, so a warm row holds the cold row's
  K/V bits.
- LRU byte budget: eviction removes least-recently-used LEAF nodes only
  (childless: every stored path stays walkable from the root). Nodes
  touched by the operation in progress carry its stamp and are
  protected, so an insert never evicts its own prefix; when nothing
  evictable remains the insert is refused rather than the budget
  overrun.
- One cache binds to ONE model and its weights: segments are raw K/V.

Segments are keyed by the port's `KVCache.planes()` names, `(layer, 'k'
| 'v')` and for an int8 cache `(layer, 'k_scale' | 'v_scale')` (the JAX
trie keys them by cache-collection leaf name); a segment's bytes, and the
budget and `stats()["bytes"]`, count every plane, as the JAX trie counts
every cache leaf. `stats()` returns
the numbers the JAX gauges publish: hits, misses, hit rate, reused
tokens, bytes, bytes saved, segments, evictions. Every lookup and insert
publishes them as the JAX trie does, as ``serving/prefix_*`` gauges,
beside the trie's share of the KV ledger (``kv/trie_blocks``,
``kv/trie_bytes``, ``kv/trie_referenced_frac``,
``kv/trie_evictable_bytes``) in observability/metrics.py's registry.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from tfde_tpu_torch import knobs
from tfde_tpu_torch.observability import metrics

DEFAULT_BYTE_BUDGET = 256 * 1024 * 1024
#: the trie's chunk and the paged pool's block (TFDE_KV_BLOCK, default 16)
DEFAULT_BLOCK = knobs.env_int("TFDE_KV_BLOCK", 16)


def block_key(tokens: np.ndarray, b: int, block: int) -> tuple:
    """The trie key of block `b` of `tokens`: its token ids as a tuple."""
    return tuple(int(t) for t in tokens[b * block:(b + 1) * block])


def stats_dict(hits: int, misses: int, reused_tokens: int, nbytes: int,
               bytes_saved: int, segments: int, evictions: int) -> dict:
    total = hits + misses
    return {
        "hits": hits,
        "misses": misses,
        "hit_rate": hits / total if total else 0.0,
        "reused_tokens": reused_tokens,
        "bytes": nbytes,
        "bytes_saved": bytes_saved,
        "segments": segments,
        "evictions": evictions,
    }


def publish_stats(stats: dict, ref: float, evictable: float) -> None:
    """The trie's gauges in the default registry: `stats` (`stats_dict`)
    as ``serving/prefix_*``, then ``kv/trie_*`` with `ref` (the share of
    the trie the current operation touched) and `evictable` (the bytes
    eviction could reclaim now)."""
    g = metrics.default_registry().gauge
    for key in ("hits", "misses", "hit_rate", "reused_tokens", "bytes",
                "bytes_saved", "segments", "evictions"):
        g(f"serving/prefix_{key}").set(stats[key])
    g("kv/trie_blocks").set(stats["segments"])
    g("kv/trie_bytes").set(stats["bytes"])
    g("kv/trie_referenced_frac").set(ref)
    g("kv/trie_evictable_bytes").set(evictable)


def match(root, tokens: np.ndarray, block: int) -> list:
    """The trie nodes of the longest cached prefix of `tokens` usable for
    a warm admission: whole blocks, at least one token left over."""
    usable = max((int(tokens.size) - 1) // block, 0)
    node, segs = root, []
    while len(segs) < usable:
        child = node.children.get(block_key(tokens, len(segs), block))
        if child is None:
            break
        segs.append(child)
        node = child
    return segs


def lru_leaf(root, op: int):
    """The least recently used childless node outside operation `op`, or
    None. O(resident segments) a victim, as in JAX."""
    victim, stack = None, [root]
    while stack:
        nxt = stack.pop()
        for child in nxt.children.values():
            if child.children:
                stack.append(child)
            elif child.op != op and (victim is None
                                     or child.last_used < victim.last_used):
                victim = child
    return victim


class _Node:
    """One block of one cached prefix path."""

    __slots__ = ("key", "parent", "children", "seg", "nbytes",
                 "last_used", "op")

    def __init__(self, key, parent):
        self.key = key              # tuple of `block` token ids
        self.parent = parent
        self.children: dict = {}
        self.seg: Optional[dict] = None   # (layer, plane) -> [block, ...]
        self.nbytes = 0
        self.last_used = 0
        self.op = 0                 # protection stamp (current operation)


class PrefixCache:
    """Token-trie prefix-KV store with an LRU byte budget.

    Handed to `ContinuousBatcher(..., prefix_cache=...)`, or resolved from
    ``TFDE_PREFIX_CACHE`` (`resolve`)."""

    def __init__(self, byte_budget: int = DEFAULT_BYTE_BUDGET,
                 block: int = DEFAULT_BLOCK):
        if block < 1:
            raise ValueError(f"block must be >= 1, got {block}")
        if byte_budget < 1:
            raise ValueError(f"byte_budget must be >= 1, got {byte_budget}")
        self._root = _Node(None, None)
        self._block = int(block)
        self._budget = int(byte_budget)
        self._bytes = 0
        self._segments = 0
        self._clock = 0      # LRU timestamps (monotonic counter)
        self._op = 0         # current-operation stamp: eviction protection
        self._hits = 0
        self._misses = 0
        self._reused_tokens = 0
        self._bytes_saved = 0
        self._evictions = 0

    @property
    def block(self) -> int:
        return self._block

    @property
    def byte_budget(self) -> int:
        return self._budget

    @property
    def resident_bytes(self) -> int:
        return self._bytes

    @property
    def segments(self) -> int:
        return self._segments

    def stats(self) -> dict:
        return stats_dict(self._hits, self._misses, self._reused_tokens,
                          self._bytes, self._bytes_saved, self._segments,
                          self._evictions)

    def lookup(self, tokens):
        """Longest cached prefix usable for prompt `tokens`: ``(L, kv)``
        with L a block multiple that leaves at least one suffix token and
        kv = {(layer, plane): [L, ...] tensor}, or ``(0, None)`` on a
        miss. Touches the matched path for LRU."""
        tokens = np.asarray(tokens).reshape(-1)
        self._op += 1
        segs = match(self._root, tokens, self._block)
        if not segs:
            self._misses += 1
            self._publish()
            return 0, None
        for s in segs:
            self._clock += 1
            s.last_used = self._clock
            s.op = self._op
        kv = {name: (torch.cat([s.seg[name] for s in segs])
                     if len(segs) > 1 else segs[0].seg[name])
              for name in segs[0].seg}
        self._hits += 1
        self._reused_tokens += len(segs) * self._block
        self._bytes_saved += sum(s.nbytes for s in segs)
        self._publish()
        return len(segs) * self._block, kv

    def insert(self, tokens, row_cache, row: int) -> int:
        """Store the complete blocks of `tokens`' K/V from row `row` of a
        prefill's row cache (a `decode.KVCache`). Returns the number of
        NEW blocks stored (resident blocks are LRU-touched only). Refuses
        blocks that cannot fit after eviction; never overruns the
        budget."""
        tokens = np.asarray(tokens).reshape(-1)
        nb = int(tokens.size) // self._block
        if nb == 0:
            return 0
        self._op += 1
        node, created = self._root, 0
        for b in range(nb):
            key = block_key(tokens, b, self._block)
            child = node.children.get(key)
            if child is None:
                seg = self._slice_block(row_cache, row, b)
                nbytes = sum(t.numel() * t.element_size()
                             for t in seg.values())
                if (self._bytes + nbytes > self._budget
                        and not self._evict(
                            self._bytes + nbytes - self._budget)):
                    break
                child = _Node(key, node)
                child.seg = seg
                child.nbytes = nbytes
                node.children[key] = child
                self._bytes += nbytes
                self._segments += 1
                created += 1
            self._clock += 1
            child.last_used = self._clock
            child.op = self._op
            node = child
        self._publish()
        return created

    def _publish(self) -> None:
        """The gauges (`publish_stats`): the referenced share and the
        evictable bytes from one walk of the trie."""
        ref = evictable = 0
        stack = list(self._root.children.values())
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            if node.op == self._op:
                ref += node.nbytes
            elif not node.children:
                evictable += node.nbytes
        publish_stats(self.stats(),
                      ref / self._bytes if self._bytes else 0.0, evictable)

    def _slice_block(self, row_cache, row: int, b: int) -> dict:
        """Copies of block `b` of row `row`, one a cache plane (k and v a
        layer, and an int8 cache's k_scale and v_scale): a view would
        keep the whole row cache alive."""
        cells = slice(b * self._block, (b + 1) * self._block)
        return {name: t[row, cells].clone()
                for name, t in row_cache.planes().items()}

    def _evict(self, need: int) -> bool:
        """Free >= `need` bytes by removing LRU leaf segments; nodes of
        the current operation are protected. False if the bytes cannot
        be freed."""
        freed = 0
        while freed < need:
            victim = lru_leaf(self._root, self._op)
            if victim is None:
                return False
            del victim.parent.children[victim.key]
            victim.seg = None
            freed += victim.nbytes
            self._bytes -= victim.nbytes
            self._segments -= 1
            self._evictions += 1
        return True


def resolve(spec) -> Optional[PrefixCache]:
    """Normalise the batcher's `prefix_cache=` argument.

    None defers to ``TFDE_PREFIX_CACHE`` (`knobs.prefix_cache_spec`:
    off, on, or an integer byte budget; any other value raises). Explicit
    values: False/0/'off' disable, True/'on' enable with the default
    budget, an int is a byte budget, and a `PrefixCache` is used as it is
    (one cache per model and weights: the caller's responsibility)."""
    if spec is None:
        spec = knobs.prefix_cache_spec()
        if spec is None:
            return None
    if isinstance(spec, PrefixCache):
        return spec
    if spec in (False, 0, "off"):
        return None
    if spec in (True, "on"):
        return PrefixCache()
    if isinstance(spec, int):
        return PrefixCache(byte_budget=spec)
    raise ValueError(f"unrecognized prefix_cache spec: {spec!r}")
