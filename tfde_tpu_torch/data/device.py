"""Host -> device feed — counterpart of `tfde_tpu/data/device.py`
(`local_slice_for_process` :24, `_to_global` :40, `device_prefetch` :53).

Batches come off the host pipeline (`data.pipeline.Dataset`) as numpy.
`device_prefetch` keeps this rank's rows of each and places them on the
model's device, `buffer_size` batches ahead of the consumer, so that the
host-to-device copy of the next batches overlaps the step that runs now.
What it yields is a `Placed` batch, which the train and eval steps take as
it is (`training.step`).

On CUDA each batch is sliced on the host, copied into a pinned staging
buffer, and copied to the card with `copy_(non_blocking=True)` on a copy
stream of the feed's own, which records an event. When the consumer takes
the batch, its current stream waits on that event and the tensors are
`record_stream`-ed on it, so the caching allocator does not hand their
memory to another tensor while a step that reads them is queued. A pinned
buffer is written again only after the copy that last read it has
completed (its event). Pinning that fails raises: the feed never falls
back to pageable or synchronous copies. On the CPU, which the caller asks
for by passing the CPU as the device, the feed yields plain CPU tensors
with no pinning and no streams.

`device_resident_feed` (:187, the whole dataset on the device) comes with
a later slice.
"""

from __future__ import annotations

import collections
import queue
import threading
import time
from typing import Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from tfde_tpu_torch.data.pipeline import AutoShardPolicy


class Placed(tuple):
    """A batch `device_prefetch` has placed: this rank's rows of each leaf,
    as tensors on the model's device. The train and eval steps use it as
    it is, where they slice a host (numpy) batch and copy it themselves.
    The mark keeps the two apart: slicing a placed batch again would train
    each of R ranks on 1/R^2 of the global batch."""


def local_slice_for_process(global_batch: int, strategy) -> Tuple[int, slice]:
    """(rows a rank, this rank's slice of a global batch): rank r of the R
    ranks of the strategy's ``data`` axis takes rows [r n/R, (r+1) n/R).
    Raises ValueError when the batch does not divide by R."""
    n, i = strategy.batch_divisor, strategy.data_rank()
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by {n} "
                         f"processes")
    per = global_batch // n
    return per, slice(i * per, (i + 1) * per)


def _host_leaves(batch, strategy, policy: AutoShardPolicy) -> list:
    """The batch's leaves as C-contiguous numpy arrays, each cut to this
    rank's rows under OFF (a tuple or list batch; anything else is one
    leaf)."""
    leaves = batch if isinstance(batch, (tuple, list)) else (batch,)
    out = []
    for x in leaves:
        x = np.asarray(x)
        if policy is AutoShardPolicy.OFF:
            x = x[local_slice_for_process(x.shape[0], strategy)[1]]
        out.append(np.ascontiguousarray(x))
    return out


def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype)).dtype


class _Slot:
    """One set of pinned staging buffers and the event of the last copy
    that read them."""

    def __init__(self):
        self.pinned: list = []
        self.views: list = []
        self.event: Optional[torch.cuda.Event] = None

    def fit(self, leaves: list) -> None:
        if [(v.shape, v.dtype) for v in self.views] == [
                (x.shape, x.dtype) for x in leaves]:
            return
        self.pinned = [torch.empty(x.shape, dtype=_torch_dtype(x.dtype),
                                   pin_memory=True) for x in leaves]
        self.views = [p.numpy() for p in self.pinned]


class _CudaStager:
    """Host leaves -> tensors on `device`, copied from pinned buffers on the
    feed's copy stream; a ring of `slots` buffer sets."""

    def __init__(self, device: torch.device, slots: int):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.ring = [_Slot() for _ in range(slots)]
        self.next = 0

    def __call__(self, leaves: list):
        slot = self.ring[self.next]
        self.next = (self.next + 1) % len(self.ring)
        if slot.event is not None:
            slot.event.synchronize()  # the copy that last read it is done
        slot.fit(leaves)
        for view, x in zip(slot.views, leaves):
            np.copyto(view, x)
        with torch.cuda.stream(self.stream):
            out = []
            for p in slot.pinned:
                t = torch.empty(p.shape, dtype=p.dtype, device=self.device)
                t.copy_(p, non_blocking=True)
                out.append(t)
            slot.event = torch.cuda.Event()
            slot.event.record(self.stream)
        return out, slot.event


class DeviceFeed:
    """The iterator `device_prefetch` returns. `wait_seconds` is the time
    the consumer has spent blocked in `next()` so far (the host pull, the
    slicing and the staging copy inline; the queue wait in background
    mode): the input-boundness of the loop that reads it. `close()` stops
    the feed and its worker."""

    def __init__(self, gen: Iterator):
        self._gen = gen
        self.wait_seconds = 0.0

    def __iter__(self) -> "DeviceFeed":
        return self

    def __next__(self) -> Placed:
        t0 = time.perf_counter()
        try:
            return next(self._gen)
        finally:
            self.wait_seconds += time.perf_counter() - t0

    def close(self) -> None:
        self._gen.close()


class _Raise:
    """A worker's exception on its way to the consumer (a batch is never
    one)."""

    def __init__(self, e: BaseException):
        self.e = e


def device_prefetch(batches: Iterable, strategy, device,
                    buffer_size: int = 2,
                    policy: AutoShardPolicy = AutoShardPolicy.DATA,
                    background: bool = False) -> DeviceFeed:
    """Yield this rank's rows of each host batch as a `Placed` tuple of
    tensors on `device`, with `buffer_size` batches staged ahead.

    Rows: under ``OFF`` every rank iterates the global batch and keeps rows
    [r n/R, (r+1) n/R) of R ranks of the strategy's ``data`` axis
    (`local_slice_for_process`); under ``DATA`` the host batch is already
    this rank's and is placed whole.

    `background=True` moves the host pull, the slicing and the staging
    into a worker thread that hands staged batches to the consumer through
    a `buffer_size`-deep queue: same batches, same order; a worker
    exception re-raises in the consumer, and closing the feed (or
    dropping it) stops the worker. See the module docstring for the CUDA
    copy and the CPU path.
    """
    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    depth = max(1, buffer_size)
    stager = _CudaStager(device, depth + 2) if cuda else None

    def stage(batch):
        leaves = _host_leaves(batch, strategy, policy)
        if cuda:
            return stager(leaves)
        return [torch.as_tensor(x) for x in leaves], None

    def deliver(staged) -> Placed:
        tensors, event = staged
        if event is not None:
            stream = torch.cuda.current_stream(device)
            stream.wait_event(event)
            for t in tensors:
                t.record_stream(stream)
        return Placed(tensors)

    if background:
        return DeviceFeed(_background(batches, stage, deliver, depth,
                                      device if cuda else None))

    def gen_inline():
        buf: collections.deque = collections.deque()
        it = iter(batches)
        try:
            while len(buf) < depth:
                buf.append(stage(next(it)))
        except StopIteration:
            pass
        while buf:
            out = buf.popleft()
            try:
                buf.append(stage(next(it)))
            except StopIteration:
                pass
            yield deliver(out)

    return DeviceFeed(gen_inline())


def _background(batches: Iterable, stage, deliver, depth: int,
                cuda_device: Optional[torch.device]):
    q: queue.Queue = queue.Queue(maxsize=depth)
    end = object()
    stop = threading.Event()

    def put(item) -> bool:
        # a bounded put that gives up once the consumer is gone, so that an
        # early close never leaves the worker blocked holding buffers
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            if cuda_device is not None:
                torch.cuda.set_device(cuda_device)
            for b in batches:
                if stop.is_set() or not put(stage(b)):
                    return
            put(end)
        except BaseException as e:  # re-raised in the consumer
            put(_Raise(e))

    thread = threading.Thread(target=worker, daemon=True,
                              name="tfde-torch-device-prefetch")
    thread.start()
    empty = queue.Empty  # bound here: a generator finalised at interpreter
    # shutdown may run after the module's globals are gone

    def gen():
        try:
            while True:
                item = q.get()
                if item is end:
                    return
                if isinstance(item, _Raise):
                    raise item.e
                yield deliver(item)
        finally:
            stop.set()
            try:
                while True:
                    q.get_nowait()
            except empty:
                pass

    return gen()
