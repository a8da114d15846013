"""The port's device feed (tfde_tpu_torch.data.device) on the CPU.

- Rows under `AutoShardPolicy.OFF` and `DATA` at two gloo ranks (file
  store): under OFF each rank keeps rows [r n/2, (r+1) n/2) of every
  global batch (`local_slice_for_process`, the split of
  `Strategy.local_rows`); under DATA each rank's host batch is
  placed whole. Inline and background feeds give the same batches.
- The inline feed stages `buffer_size` batches ahead of the consumer.
- `background=True`: an exception from the source re-raises in the
  consumer after the batches before it; closing the feed early stops its
  worker thread.
- A `Placed` batch goes through the train step as it is (the host batch
  of the same rows gives the same step) and must lie on the model's
  device.

The CUDA path (pinned staging, the copy stream, events) runs only on the
card: `chip_smoke.py`'s lifecycle phase drives it.
"""

import threading
import time

import numpy as np
import pytest
import torch

from tfde_tpu_torch import testing
from tfde_tpu_torch.data.device import (
    Placed, device_prefetch, local_slice_for_process)
from tfde_tpu_torch.models.cnn import BatchNormCNN
from tfde_tpu_torch.parallel.strategies import MultiWorkerMirroredStrategy
from tfde_tpu_torch.runtime.mesh import LocalMesh
from tfde_tpu_torch.training.optimizers import sgd
from tfde_tpu_torch.training.step import init_state, make_train_step

#: one intra-op torch thread for the module (`testing.one_thread`)
_one_thread = pytest.fixture(autouse=True, scope="module")(testing.one_thread)


def _batches(n=4, rows=6):
    rng = np.random.default_rng(0)
    return [(rng.random((rows, 3), np.float32),
             rng.integers(0, 10, (rows, 1)).astype(np.int64))
            for _ in range(n)]


def _local():
    return MultiWorkerMirroredStrategy(mesh=LocalMesh(("data",)))


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """What each of two gloo ranks placed, under both policies, inline and
    in the background (one spawn for all four)."""
    store = str(tmp_path_factory.mktemp("feed") / "store")
    return testing.run_ranks(testing.feed_worker, [(2, store, _batches())] * 2)


@pytest.mark.parametrize("policy", ["OFF", "DATA"])
def test_rows_at_two_gloo_ranks(policy, two_ranks):
    for rank in range(2):
        inline = two_ranks[rank][policy, "inline"]
        background = two_ranks[rank][policy, "background"]
        for got, bg, host in zip(inline, background, _batches(), strict=True):
            for g, b, h in zip(got, bg, host, strict=True):
                want = h[rank * 3:(rank + 1) * 3] if policy == "OFF" else h
                assert g.dtype == h.dtype
                assert np.array_equal(g, want)
                assert np.array_equal(b, want)


def test_local_slice_for_process_at_one_rank():
    assert local_slice_for_process(8, _local()) == (8, slice(0, 8))


def test_inline_feed_stages_buffer_size_ahead():
    pulled = []

    def source():
        for i, b in enumerate(_batches(6)):
            pulled.append(i)
            yield b

    feed = device_prefetch(source(), _local(), "cpu", buffer_size=2)
    first = next(feed)
    assert isinstance(first, Placed) and pulled == [0, 1, 2]
    assert all(isinstance(x, torch.Tensor) and x.device.type == "cpu"
               for x in first)
    rest = list(feed)
    assert len(rest) == 5 and pulled == list(range(6))
    assert feed.wait_seconds > 0


def test_background_source_error_reaches_the_consumer():
    def source():
        yield from _batches(3)
        raise ValueError("source broke at batch 3")

    feed = device_prefetch(source(), _local(), "cpu", background=True)
    got = [next(feed) for _ in range(3)]
    for g, h in zip(got, _batches(3)):
        assert np.array_equal(g[0].numpy(), h[0])
    with pytest.raises(ValueError, match="batch 3"):
        next(feed)


def _worker_threads():
    return [t for t in threading.enumerate()
            if t.name == "tfde-torch-device-prefetch"]


def test_background_feed_closed_early_stops_its_worker():
    def endless():
        while True:
            yield from _batches(2)

    before = len(_worker_threads())
    feed = device_prefetch(endless(), _local(), "cpu", buffer_size=2,
                           background=True)
    next(feed)
    next(feed)
    assert len(_worker_threads()) == before + 1
    feed.close()
    deadline = time.time() + 10
    while len(_worker_threads()) > before and time.time() < deadline:
        time.sleep(0.05)
    assert len(_worker_threads()) == before


def test_placed_batch_trains_as_its_host_batch():
    from tfde_tpu_torch.data.datasets import mnist

    (x, y), _ = mnist(flatten=True, n_train=32, n_test=8)
    results = []
    for placed in (False, True):
        model = BatchNormCNN(dropout_rate=0.0, device="cpu", seed=0)
        state = init_state(model, sgd(model, 0.1))
        step = make_train_step(_local(), state)
        batch = ((x, y) if not placed else
                 next(device_prefetch([(x, y)], _local(), "cpu")))
        _, metrics = step(state, batch)
        results.append((float(metrics["loss"]),
                        [p.detach().clone() for p in model.parameters()]))
    assert results[0][0] == results[1][0]
    for a, b in zip(results[0][1], results[1][1]):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="placed batch on meta"):
        step(state, Placed((torch.empty(4, 784, device="meta"),
                            torch.empty(4, 1, device="meta"))))
