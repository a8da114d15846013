"""The port's native host loader (tfde_tpu_torch.native, a copy of the JAX
package's loader.cc behind its own ctypes shim) on the CPU.

- The nine cases of `tests/test_native_loader.py` on the port's loader:
  epoch coverage, repeat().batch() across epochs, seed determinism, no
  shuffle, infinite repeat, copy mode, the multiset of the Python
  pipeline, close() while a consumer is blocked, a batch larger than the
  dataset.
- The same batches as the JAX package's `NativeBatchLoader`, bit for bit,
  for the same arrays and seed, with and without repeat and
  drop_remainder.
- An explicit request without the library (`NativeBatchLoader`,
  `cifar10_resnet.make_train_dataset(use_native=True)`) raises and never
  runs the Python pipeline; ``use_native=None`` then takes it.
- The ring aliases: a yielded view is overwritten once the loader moves
  on, and `device_prefetch` stages each batch before it pulls the next,
  so the batches it yields are the loader's, not whatever the slots hold
  later.
- The library is built into `build/native/` (or ``$TFDE_NATIVE_CACHE``),
  named by a hash of its source and flags.
"""

import os
import threading
import time

import numpy as np
import pytest

from tfde_tpu import native as jnative
from tfde_tpu_torch import cifar10_resnet, native
from tfde_tpu_torch.data import Dataset, datasets
from tfde_tpu_torch.data.device import device_prefetch
from tfde_tpu_torch.data.pipeline import AutoShardPolicy
from tfde_tpu_torch.parallel.strategies import MultiWorkerMirroredStrategy
from tfde_tpu_torch.runtime.mesh import LocalMesh
from tfde_tpu_torch.testing import one_thread

#: one intra-op torch thread for the module (`testing.one_thread`)
_one_thread = pytest.fixture(autouse=True, scope="module")(one_thread)


@pytest.fixture(autouse=True)
def _library():
    """Every test here needs the library, so g++ (the CPU test machine and
    the card's machine both have it)."""
    assert native.available()


def _arrays(n=100, d=7):
    x = np.arange(n * d, dtype=np.float32).reshape(n, d)
    y = np.arange(n, dtype=np.int64).reshape(n, 1)
    return x, y


def test_library_is_built_beside_the_package(monkeypatch, tmp_path):
    path = native.library_path()
    assert os.path.dirname(path) == native.BUILD_DIR
    assert os.path.basename(path).startswith("tfde_loader-")
    assert os.path.exists(path)
    monkeypatch.setenv("TFDE_NATIVE_CACHE", str(tmp_path))
    assert native.library_path() == str(tmp_path / os.path.basename(path))


def test_one_epoch_covers_every_row_once():
    x, y = _arrays()
    loader = native.NativeBatchLoader([x, y], batch_size=16, seed=3, repeat=1)
    seen = []
    for bx, by in loader:
        assert bx.shape[1:] == (7,) and by.shape[1:] == (1,)
        # rows stay consistent across arrays (one gather index)
        np.testing.assert_array_equal(bx[:, 0],
                                      (by[:, 0] * 7).astype(np.float32))
        seen.extend(by[:, 0].tolist())
    assert sorted(seen) == list(range(100))  # a permutation
    assert len(seen) == 100  # the final short batch of 4 included


def test_drop_remainder_and_repeat_cross_epoch_batches():
    x, y = _arrays(n=10)
    batches = list(native.NativeBatchLoader(
        [x, y], batch_size=4, seed=0, repeat=2, drop_remainder=True,
        copy=True))
    assert len(batches) == 5  # 20 rows; the 3rd batch spans the boundary
    counts = np.bincount(np.concatenate([b[1][:, 0] for b in batches]),
                         minlength=10)
    assert counts.sum() == 20 and counts.max() <= 2


def test_seed_determinism_and_difference():
    _, y = _arrays(n=50)

    def order(seed):
        loader = native.NativeBatchLoader([y], batch_size=50, seed=seed,
                                          repeat=1)
        return next(iter(loader))[0][:, 0].tolist()

    assert order(7) == order(7)
    assert order(7) != order(8)


def test_no_shuffle_is_sequential():
    _, y = _arrays(n=12)
    loader = native.NativeBatchLoader([y], batch_size=5, shuffle=False,
                                      repeat=1)
    rows = np.concatenate([b[0][:, 0].copy() for b in loader])
    np.testing.assert_array_equal(rows, np.arange(12))


def test_infinite_repeat_streams():
    x, _ = _arrays(n=8)
    loader = native.NativeBatchLoader([x], batch_size=8, seed=1)
    it = iter(loader)
    for _ in range(10):
        (bx,) = next(it)
        assert bx.shape == (8, 7)
    loader.close()


def test_copy_mode_yields_owned_arrays():
    x, _ = _arrays(n=32)
    loader = native.NativeBatchLoader([x], batch_size=8, seed=0, repeat=1,
                                      copy=True)
    first = next(iter(loader))[0]
    ref = first.copy()
    for _ in loader:  # drain: the slots are reused
        pass
    np.testing.assert_array_equal(first, ref)


def test_matches_python_pipeline_multiset():
    x, y = _arrays(n=40)
    py = Dataset.from_tensor_slices((x, y)).shuffle(40, seed=5).repeat(1) \
        .batch(8)
    py_rows = sorted(r for b in py for r in b[1][:, 0].tolist())
    nat = native.NativeBatchLoader([x, y], batch_size=8, seed=5, repeat=1)
    assert py_rows == sorted(r for b in nat for r in b[1][:, 0].tolist())


def test_close_while_consumer_blocked_in_next():
    """close() from another thread wakes a consumer blocked inside next()
    (StopIteration) and returns promptly."""
    n = 1 << 19
    data = np.arange(n, dtype=np.int64).reshape(n, 1)
    loader = native.NativeBatchLoader([data], batch_size=n // 4, seed=0,
                                      num_threads=1, depth=2)
    consumed = []

    def consume():
        try:
            for (b,) in loader:  # infinite: only close() ends this
                consumed.append(b.shape[0])
        except Exception:
            pass

    t = threading.Thread(target=consume, daemon=True)
    t.start()
    time.sleep(0.2)
    start = time.perf_counter()
    loader.close()
    t.join(timeout=10.0)
    assert not t.is_alive(), "consumer never woke after close"
    assert time.perf_counter() - start < 10.0
    assert consumed


def test_batch_larger_than_dataset_spans_many_epochs():
    y = np.arange(10, dtype=np.int64).reshape(10, 1)
    loader = native.NativeBatchLoader([y], batch_size=32, seed=3, repeat=4,
                                      copy=True)
    rows = np.concatenate([b[0][:, 0] for b in loader])
    assert len(rows) == 40
    np.testing.assert_array_equal(np.bincount(rows, minlength=10), 4)


@pytest.mark.parametrize("repeat,drop", [(1, False), (3, False), (3, True),
                                         (None, True)])
@pytest.mark.parametrize("shuffle", [True, False])
def test_batches_equal_the_jax_loader_bit_for_bit(repeat, drop, shuffle):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((37, 4, 3)).astype(np.float32)
    y = rng.integers(0, 10, (37, 1)).astype(np.int64)
    kw = dict(batch_size=8, shuffle=shuffle, seed=11, repeat=repeat,
              drop_remainder=drop, copy=True)
    ours = native.NativeBatchLoader([x, y], **kw)
    theirs = jnative.NativeBatchLoader([x, y], **kw)
    n = 0
    for a, b in zip(ours, theirs):
        assert len(a) == len(b) == 2
        for u, v in zip(a, b):
            assert u.dtype == v.dtype and u.tobytes() == v.tobytes()
        n += 1
        if n == 30:
            break
    ours.close()
    theirs.close()
    if repeat is not None:
        rows = 37 * repeat
        assert n == (rows // 8 if drop else -(-rows // 8))


def test_explicit_request_without_the_library_raises(monkeypatch):
    monkeypatch.setattr(native, "_get_lib", lambda: None)
    loaded = []
    monkeypatch.setattr(datasets, "cifar10",
                        lambda *a, **k: loaded.append(1))
    with pytest.raises(RuntimeError, match="native loader"):
        native.NativeBatchLoader(list(_arrays()), batch_size=4)
    with pytest.raises(RuntimeError, match="use_native=True"):
        cifar10_resnet.make_train_dataset(8, use_native=True)
    assert not loaded  # the Python pipeline never ran
    assert not native.available()
    small = datasets._synthetic_images(16, 2, 32, 10, seed=1)
    monkeypatch.setattr(datasets, "cifar10", lambda: small)
    ds = cifar10_resnet.make_train_dataset(8, use_native=None)
    assert isinstance(ds, Dataset)  # the open choice takes the pipeline


def test_ring_views_are_reused_and_the_feed_stages_before_pulling():
    x, y = _arrays(n=64)
    kw = dict(batch_size=8, seed=2, repeat=1, depth=2, num_threads=1)
    want = list(native.NativeBatchLoader([x, y], copy=True, **kw))
    # a view kept past the next pulls shows another batch: batch b lands
    # in slot b % depth, which batch 2 takes once batch 1 is pulled
    loader = native.NativeBatchLoader([x, y], **kw)
    first = next(loader)
    np.testing.assert_array_equal(first[1], want[0][1])
    next(loader)
    next(loader)
    np.testing.assert_array_equal(first[1], want[2][1])
    assert not np.array_equal(first[1], want[0][1])
    loader.close()
    # device_prefetch pulls `buffer_size` batches ahead and must have
    # staged each before the next pull
    strategy = MultiWorkerMirroredStrategy(mesh=LocalMesh(("data",)))
    feed = device_prefetch(native.NativeBatchLoader([x, y], **kw), strategy,
                           "cpu", buffer_size=3, policy=AutoShardPolicy.OFF)
    got = [tuple(t.numpy() for t in b) for b in feed]
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0], w[0])
        np.testing.assert_array_equal(g[1], w[1])


def test_crc32c_native_matches_the_table_and_jax():
    from tfde_tpu.observability import tensorboard as jtb
    from tfde_tpu_torch.observability import tensorboard as tb

    rng = np.random.default_rng(0)
    for n in (0, 1, 7, 8, 9, 1000, 4099):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        want = tb.crc32c_table(data)
        assert native.crc32c(data) == want
        assert tb.crc32c(data) == want
        assert jtb.crc32c(data) == want
    assert native.crc32c(b"123456789") == 0xE3069283  # the check value
