"""Composable host-side input pipeline (the tf.data analog) — a copy of
`tfde_tpu/data/pipeline.py`, so that the port never imports the JAX
package. It is numpy and threads only; the same seeds give the same
batches, bit for bit, as the JAX package's `Dataset`.

Reproduces the observable semantics the reference relies on:

- `from_tensor_slices` + `.shuffle(1000).repeat().batch(B).prefetch(100)` for
  training and plain `.batch(B)` for eval/predict
  (mnist_keras_distributed.py:123-148, duplicated tf2_mnist:38-63);
- `.map(scale).cache().shuffle(10000)` then global-batching
  (distributed_with_keras.py:18-30,54);
- `AutoShardPolicy` OFF vs DATA (distributed_with_keras.py:55-57): under DATA
  each rank reads its own example shard; under OFF every rank iterates the
  identical stream and keeps its rows of each *global* batch
  (`data.device.device_prefetch`) — the reference's global-batch
  accounting (dwk:13-15).

Semantics notes (tf.data-compatible):
- `repeat().batch()` batches across epoch boundaries — never a per-epoch
  short batch.
- seeded `shuffle` reshuffles every epoch (reshuffle-each-iteration): epoch k
  uses seed+k; a fresh iterator restarts the same deterministic sequence.
- exceptions raised inside the pipeline (map fns, sources) propagate to the
  consumer, including through `prefetch`'s background thread.

Design: nodes are iterator factories over numpy, threaded by an *epoch index*
(`make_iter(epoch)`) so `repeat` can drive per-epoch reshuffling upstream.
`batch` is vectorized — one permutation + one fancy-indexed gather per batch —
whenever the upstream chain is slice-preserving (source, elementwise map,
cache, full-buffer shuffle, repeat); otherwise it falls back to the exact
per-element path. Left out: the JAX package's native C++ loader source
(`tfde_tpu/native`), which comes with a later slice of the port.
"""

from __future__ import annotations

import dataclasses
import enum
import queue
import threading
from typing import Any, Callable, Iterator, Optional, Tuple

import numpy as np

Element = Tuple[np.ndarray, ...]

_NO_SHUFFLE = object()


@dataclasses.dataclass
class _FastPath:
    """State for the vectorized batch path: sliceable arrays + pending
    shuffle/repeat transformations that commute with slicing."""

    arrays_thunk: Callable[[], Tuple[np.ndarray, ...]]  # lazy (deferred maps)
    n: int
    perm_seed: Any = _NO_SHUFFLE  # _NO_SHUFFLE | None | int
    repeat: Optional[int] = 1  # None = infinite

    def evolved(self, **kw) -> "_FastPath":
        return dataclasses.replace(self, **kw)


class Dataset:
    """A lazily-evaluated pipeline; each op returns a new Dataset."""

    def __init__(
        self,
        make_iter: Callable[..., Iterator[Element]],
        size: Optional[int],
        fast: Optional[_FastPath] = None,
    ):
        # make_iter accepts an optional epoch index (for per-epoch reshuffle).
        self._make_iter = make_iter
        self._size = size  # elements per iteration where known; None unknown/infinite
        self._fast = fast

    def _iter_epoch(self, epoch: int = 0) -> Iterator[Element]:
        try:
            return self._make_iter(epoch)
        except TypeError:
            return self._make_iter()

    # -- sources -------------------------------------------------------------
    @staticmethod
    def from_tensor_slices(arrays: Any) -> "Dataset":
        """Source over the leading axis of one array or a tuple of arrays
        (mnist_keras:142)."""
        if not isinstance(arrays, (tuple, list)):
            arrays = (arrays,)
        arrays = tuple(np.asarray(a) for a in arrays)
        n = arrays[0].shape[0]
        for a in arrays:
            if a.shape[0] != n:
                raise ValueError("all arrays must share the leading dimension")

        def it(epoch=0):
            for i in range(n):
                yield tuple(a[i] for a in arrays)

        return Dataset(it, n, fast=_FastPath(lambda: arrays, n))

    # -- transformations -----------------------------------------------------
    def map(self, fn: Callable[..., Any]) -> "Dataset":
        def it(epoch=0):
            for el in self._iter_epoch(epoch):
                out = fn(*el)
                yield out if isinstance(out, tuple) else (out,)

        fast = None
        if self._fast is not None:
            parent = self._fast

            def mapped_thunk():
                src = parent.arrays_thunk()
                mapped = fn(*src)
                mapped = mapped if isinstance(mapped, tuple) else (mapped,)
                mapped = tuple(np.asarray(m) for m in mapped)
                # A whole-array map equals the per-element map only for
                # elementwise/broadcasting fns (the reference's are,
                # dwk:20-23). Verify on element 0; reductions or
                # shape-dependent fns fail and void the fast path.
                el0 = fn(*(a[0] for a in src))
                el0 = el0 if isinstance(el0, tuple) else (el0,)
                ok = len(mapped) == len(el0) and all(
                    m.shape[0] == src[0].shape[0]
                    and np.allclose(m[0], np.asarray(e), equal_nan=True)
                    for m, e in zip(mapped, el0)
                )
                return mapped if ok else None

            fast = parent.evolved(arrays_thunk=_memo(mapped_thunk))
        return Dataset(it, self._size, fast=fast)

    def cache(self) -> "Dataset":
        """Materialize once on first full pass (dwk:30)."""
        store: list[Element] = []
        done = threading.Event()

        def it(epoch=0):
            if done.is_set():
                yield from store
                return
            buf = []
            for el in self._iter_epoch(epoch):
                buf.append(el)
                yield el
            store[:] = buf
            done.set()

        return Dataset(it, self._size, fast=self._fast)

    def shuffle(self, buffer_size: int, seed: Optional[int] = None) -> "Dataset":
        """Windowed buffer shuffle, tf.data semantics (mnist_keras:144):
        reshuffles each epoch; with a seed the epoch sequence is deterministic.
        """
        def it(epoch=0):
            rng = np.random.default_rng(None if seed is None else seed + epoch)
            buf: list[Element] = []
            for el in self._iter_epoch(epoch):
                if len(buf) < buffer_size:
                    buf.append(el)
                    continue
                j = int(rng.integers(buffer_size))
                out = buf[j]
                buf[j] = el
                yield out
            rng.shuffle(buf)
            yield from buf

        fast = None
        if self._fast is not None and self._size is not None and buffer_size >= self._size:
            # Full-buffer shuffle == a fresh permutation per epoch.
            fast = self._fast.evolved(perm_seed=seed)
        return Dataset(it, self._size, fast=fast)

    def repeat(self, count: Optional[int] = None) -> "Dataset":
        def it(epoch=0):
            n = 0
            while count is None or n < count:
                yield from self._iter_epoch(n)
                n += 1

        size = None if (count is None or self._size is None) else self._size * count
        fast = self._fast.evolved(repeat=count) if self._fast is not None else None
        return Dataset(it, size, fast=fast)

    def shard(self, num_shards: int, index: int) -> "Dataset":
        """Every num_shards-th element — AutoShardPolicy.DATA per-host shard."""
        def it(epoch=0):
            for i, el in enumerate(self._iter_epoch(epoch)):
                if i % num_shards == index:
                    yield el

        size = None if self._size is None else (self._size - index + num_shards - 1) // num_shards
        return Dataset(it, size)

    def batch(self, batch_size: int, drop_remainder: bool = False) -> "Dataset":
        """Stack consecutive elements; vectorized when the chain allows."""
        if self._fast is not None:
            arrays = self._fast.arrays_thunk()  # None if a map was non-elementwise
            if arrays is not None:
                return _VectorBatched(arrays, batch_size, drop_remainder, self._fast)

        def it(epoch=0):
            buf: list[Element] = []
            for el in self._iter_epoch(epoch):
                buf.append(el)
                if len(buf) == batch_size:
                    yield tuple(np.stack(c) for c in zip(*buf))
                    buf = []
            if buf and not drop_remainder:
                yield tuple(np.stack(c) for c in zip(*buf))

        size = None
        if self._size is not None:
            size = self._size // batch_size if drop_remainder else -(-self._size // batch_size)
        return Dataset(it, size)

    def prefetch(self, buffer_size: int = 2) -> "Dataset":
        """Background-thread prefetch (mnist_keras:145). Upstream exceptions
        propagate to the consumer."""
        def it(epoch=0):
            q: queue.Queue = queue.Queue(maxsize=max(1, buffer_size))
            stop = object()
            err: list[BaseException] = []

            def worker():
                try:
                    for el in self._iter_epoch(epoch):
                        q.put(el)
                except BaseException as e:  # propagate, don't truncate
                    err.append(e)
                finally:
                    q.put(stop)

            t = threading.Thread(target=worker, daemon=True)
            t.start()
            while True:
                el = q.get()
                if el is stop:
                    if err:
                        raise err[0]
                    return
                yield el

        return Dataset(it, self._size)

    # -- consumption ---------------------------------------------------------
    def __iter__(self) -> Iterator[Element]:
        return self._iter_epoch(0)

    def __len__(self) -> int:
        if self._size is None:
            raise TypeError("dataset size unknown (infinite or un-counted)")
        return self._size

    @property
    def size(self) -> Optional[int]:
        return self._size


def _memo(thunk):
    cell = []

    def memoized():
        if not cell:
            cell.append(thunk())
        return cell[0]

    return memoized


class _VectorBatched(Dataset):
    """Vectorized shuffle+repeat+batch over sliceable arrays.

    Host hot path: one `rng.permutation` per epoch and one fancy-indexed
    gather per batch — no per-example Python. Batches run across epoch
    boundaries (tf.data repeat().batch() semantics)."""

    def __init__(self, arrays, batch_size, drop_remainder, fast: _FastPath):
        self._arrays = arrays
        self._bs = batch_size
        self._drop = drop_remainder
        self._seed = fast.perm_seed
        self._rep = fast.repeat  # None = infinite
        self._n = fast.n
        total = None if fast.repeat is None else fast.n * fast.repeat
        size = None
        if total is not None:
            size = total // batch_size if drop_remainder else -(-total // batch_size)
        super().__init__(self._iter, size)

    def _epoch_indices(self, epoch: int) -> np.ndarray:
        if self._seed is _NO_SHUFFLE:
            return np.arange(self._n)
        rng = np.random.default_rng(None if self._seed is None else self._seed + epoch)
        return rng.permutation(self._n)

    def _iter(self, _epoch: int = 0):
        epoch, carry = 0, np.empty((0,), np.int64)
        while self._rep is None or epoch < self._rep:
            idx = np.concatenate([carry, self._epoch_indices(epoch)])
            stop = len(idx) - (len(idx) % self._bs)
            for s in range(0, stop, self._bs):
                sel = idx[s : s + self._bs]
                yield tuple(a[sel] for a in self._arrays)
            carry = idx[stop:]
            epoch += 1
        if len(carry) and not self._drop:
            yield tuple(a[carry] for a in self._arrays)


class AutoShardPolicy(enum.Enum):
    """Input-sharding policy across hosts (distributed_with_keras.py:55-57).

    OFF: every host iterates the identical full stream and slices its own
    portion out of each global batch. DATA: each host reads every
    num_shards-th example (its own shard)."""

    OFF = "off"
    DATA = "data"
