"""Streaming file-backed input — counterpart of `tfde_tpu/data/streaming.py`
(`shard_files` :51, `StreamingTFRecordLoader` :72): TFRecord shards ->
windowed shuffle -> native gather ring -> device.

The composition tf.data's C++ engine gives the reference
(``TFRecordDataset -> shuffle -> batch -> prefetch``), for datasets that
do not fit in host memory:

- a READER thread decodes this host's shard files (CRC-checked,
  `data.tfrecord`) into fixed [window, ...] numpy buffers, one queued
  ahead: at most two windows are resident, never the dataset;
- each filled window feeds a fresh `native.NativeBatchLoader` (the
  permutation and the row gather outside the interpreter lock) while the
  reader fills the next; without the native library the gather is numpy
  fancy indexing, with the same semantics (another permutation stream,
  the JAX package's fallback too);
- the shuffle is WINDOWED (a buffer of `window` rows, tf.data's
  ``shuffle(buffer_size)``), seeded and per epoch: the file order is
  drawn from ``default_rng((seed, epoch))``, each window's permutation
  seed from ``default_rng((seed, 7, window index))``, and a window never
  spans an epoch, so every record of epoch N comes before any of epoch
  N + 1; the consumer re-batches across windows, so batches stay full
  across the boundary (``repeat().batch()``);
- multi-host sharding is by FILE, round robin (`shard_files`, tf.data's
  ``AutoShardPolicy.FILE``).

The same files, seed and sizes give the JAX loader's batches bit for bit.
The batches reach the device through `data.device.device_prefetch`.
Local paths only (`data.tfrecord.local_path`).
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Optional, Sequence, Tuple, Union

import numpy as np

from tfde_tpu_torch.data.tfrecord import local_path, read_tfrecord


def shard_files(
    paths: Sequence[str], host_index: int, host_count: int
) -> list:
    """Round-robin file assignment (AutoShardPolicy.FILE semantics): host
    h takes files h, h+H, h+2H, ... Raises when hosts would starve —
    fewer files than hosts means file-level sharding cannot feed every
    host; re-shard the dataset or use record-level `Dataset.shard`."""
    if not 0 <= host_index < host_count:
        raise ValueError(
            f"host_index {host_index} not in [0, {host_count})"
        )
    if len(paths) < host_count:
        raise ValueError(
            f"{len(paths)} files cannot file-shard across {host_count} "
            f"hosts — every host needs at least one file (write more "
            f"shards, or use record-level Dataset.shard on a "
            f"tfrecord_dataset)"
        )
    return list(paths[host_index::host_count])


class StreamingTFRecordLoader:
    """shuffle/repeat/batch over TFRecord shards that never materializes
    the dataset in memory (module docstring has the architecture).

    paths: this host's shard files (apply `shard_files` first in
    multi-host jobs, or pass host_index/host_count to do it here).
    parse_fn: bytes -> tuple of fixed-shape numpy values (row contract;
    shapes/dtypes are pinned by the first record and enforced after).
    window: shuffle-buffer rows resident at once (2 windows peak).
    repeat: None = infinite epochs (the training default), k = k passes.

    Yields tuples of numpy batch arrays; the final partial batch of the
    final epoch is dropped iff drop_remainder. Iteration is
    single-consumer; `close()` (or GC) stops the reader thread.
    """

    def __init__(
        self,
        paths: Union[str, Sequence[str]],
        parse_fn: Callable[[bytes], tuple],
        batch_size: int,
        window: int = 65536,
        shuffle: bool = True,
        seed: int = 0,
        repeat: Optional[int] = None,
        drop_remainder: bool = False,
        host_index: Optional[int] = None,
        host_count: Optional[int] = None,
        num_threads: int = 2,
        depth: int = 4,
        # True (default): yielded arrays are owned. False hands out views
        # of the native ring's slots, valid only until the next iteration:
        # only for a consumer that is done with a batch before it pulls
        # the next (`device_prefetch` copies each batch as it stages it)
        copy: bool = True,
    ):
        if isinstance(paths, str):
            paths = [paths]
        paths = [local_path(p) for p in paths]
        if not paths:
            raise ValueError("need at least one TFRecord file")
        if (host_index is None) != (host_count is None):
            raise ValueError(
                "pass host_index and host_count together (or neither)"
            )
        if host_index is not None:
            paths = shard_files(paths, host_index, host_count)
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        if window < batch_size:
            raise ValueError(
                f"window ({window}) must be >= batch_size ({batch_size}) "
                f"— a window is the shuffle buffer batches draw from"
            )
        if repeat is not None and repeat < 0:
            raise ValueError(f"repeat must be None or >= 0, got {repeat}")
        self._paths = paths
        self._parse = parse_fn
        self._batch = int(batch_size)
        self._window = int(window)
        self._shuffle = bool(shuffle)
        self._seed = int(seed)
        self._repeat = repeat
        self._drop_remainder = bool(drop_remainder)
        self._native_kw = dict(num_threads=num_threads, depth=depth,
                               copy=copy)
        # (bufs, count, is_last) | ('error', exc) | None = reader done
        self._q: "queue.Queue" = queue.Queue(maxsize=1)
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._reader, name="tfde-stream-reader", daemon=True
        )
        self._thread.start()
        self._inner = None  # gather engine over the current window
        self._window_idx = 0
        self._done = False
        self._leftover = None  # rows spilling across a window boundary

    # -- reader thread ------------------------------------------------------
    _EPOCH_END = object()

    def _rows(self):
        epoch = 0
        while self._repeat is None or epoch < self._repeat:
            paths = self._paths
            if self._shuffle:
                order = np.random.default_rng(
                    (self._seed, epoch)
                ).permutation(len(paths))
                paths = [self._paths[i] for i in order]
            n_epoch = 0
            for p in paths:
                for rec in read_tfrecord(p):
                    if self._stop.is_set():
                        return
                    n_epoch += 1
                    yield self._parse(rec)
            if n_epoch == 0:
                return  # empty dataset: repeating it forever yields nothing
            epoch += 1
            # windows must not span epochs: shuffle is per-epoch
            # (tf.data `shuffle(B).repeat()` order — all of epoch N
            # precedes epoch N+1), so the reader flushes at the boundary
            yield self._EPOCH_END

    def _reader(self):
        try:
            rows = self._rows()
            first = next(rows, None)
            if first is None:
                self._q.put(None)
                return
            first = tuple(np.asarray(v) for v in first)
            shapes = [v.shape for v in first]
            dtypes = [v.dtype for v in first]
            carry = [first]
            exhausted = False
            while not exhausted and not self._stop.is_set():
                bufs = [
                    np.empty((self._window,) + sh, dt)
                    for sh, dt in zip(shapes, dtypes)
                ]
                count = 0
                for row in carry:
                    for b, v in zip(bufs, row):
                        b[count] = v
                    count += 1
                carry = []
                while count < self._window:
                    row = next(rows, None)
                    if row is None:
                        exhausted = True
                        break
                    if row is self._EPOCH_END:
                        break  # flush: a window never spans epochs
                    row = tuple(np.asarray(v) for v in row)
                    for v, sh, dt in zip(row, shapes, dtypes):
                        if v.shape != sh or v.dtype != dt:
                            raise ValueError(
                                f"record {count} of window "
                                f"{self._window_idx} has shape/dtype "
                                f"{v.shape}/{v.dtype}, expected {sh}/{dt} "
                                f"— parse_fn must yield fixed-shape rows"
                            )
                    for b, v in zip(bufs, row):
                        b[count] = v
                    count += 1
                # no tail trimming: each window's gather emits a short
                # final chunk and the CONSUMER re-batches across windows —
                # boundary rows therefore precede the next window's (the
                # tf.data `shuffle(B).repeat().batch()` ordering law:
                # every epoch-N record is emitted before any epoch-N+1
                # record)
                if count:
                    self._q.put((bufs, count, exhausted))
            self._q.put(None)
        except BaseException as e:  # surface in the consumer, not the log
            self._q.put(("error", e))

    # -- consumer -----------------------------------------------------------
    def _next_window(self):
        item = self._q.get()
        if item is None:
            self._done = True
            raise StopIteration
        if isinstance(item, tuple) and len(item) == 2 and item[0] == "error":
            self._done = True
            raise item[1]
        bufs, count, is_last = item
        views = [b[:count] for b in bufs]
        seed = np.random.default_rng(
            (self._seed, 7, self._window_idx)
        ).integers(0, 2**63)
        self._window_idx += 1
        from tfde_tpu_torch import native

        # engines always emit the window's short final chunk
        # (drop_remainder=False): __next__ re-batches across windows, so
        # boundary rows keep their position in the stream
        if native.available():
            self._inner = native.NativeBatchLoader(
                views, self._batch, shuffle=self._shuffle, seed=int(seed),
                repeat=1, drop_remainder=False, **self._native_kw,
            )
        else:
            self._inner = self._numpy_window(views, count, int(seed))

    def _numpy_window(self, views, count, seed):
        order = (np.random.default_rng(seed).permutation(count)
                 if self._shuffle else np.arange(count))

        def gen():
            for start in range(0, count, self._batch):
                idx = order[start : start + self._batch]
                yield tuple(v[idx] for v in views)

        return gen()

    def __iter__(self):
        return self

    def _pull_chunk(self):
        """Next (possibly short) chunk from the window engines."""
        while True:
            if self._inner is None:
                self._next_window()  # raises StopIteration at end
            try:
                return next(self._inner)
            except StopIteration:
                self._inner = None

    def __next__(self) -> Tuple[np.ndarray, ...]:
        if self._done:
            raise StopIteration
        parts = [self._leftover] if self._leftover is not None else []
        have = parts[0][0].shape[0] if parts else 0
        while have < self._batch:
            try:
                chunk = self._pull_chunk()
            except StopIteration:
                if parts and not self._drop_remainder:
                    self._leftover = None
                    self._done = True
                    return tuple(np.concatenate(c, axis=0) if len(parts) > 1
                                 else c[0]
                                 for c in zip(*parts))
                self._done = True
                raise
            parts.append(chunk)
            have += chunk[0].shape[0]
        merged = tuple(
            np.concatenate(c, axis=0) if len(parts) > 1 else c[0]
            for c in zip(*parts)
        )
        if have > self._batch:
            # copy the spill: under copy=False it would otherwise alias a
            # ring slot that the next _pull_chunk recycles
            self._leftover = tuple(a[self._batch :].copy() for a in merged)
            merged = tuple(a[: self._batch] for a in merged)
        else:
            self._leftover = None
        return merged

    def close(self) -> None:
        self._stop.set()
        inner, self._inner = self._inner, None
        if inner is not None and hasattr(inner, "close"):
            inner.close()
        # drain until the reader exits: it may be blocked in q.put (full
        # queue) and needs one more drain after waking to place its final
        # sentinel; bounded loop so close never hangs on a wedged thread
        for _ in range(1000):
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
            if not self._thread.is_alive():
                break
            self._thread.join(0.01)
        self._done = True

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
