"""The port's host pipeline (tfde_tpu_torch.data.pipeline, a copy of
tfde_tpu/data/pipeline.py) against the JAX package's `Dataset`: the same
arrays through the same chain must give the same batches, bit for bit
(values, shapes and dtypes), on the vectorised path and on the
per-element path.

Chains: `examples/mnist_multiworker.py` (map, cache, a 10000-element
windowed shuffle, repeat, global batches), `examples/mnist_estimator.py`
(`input_fn` train: a full shuffle, repeat, batch, prefetch; eval: plain
batches, the last ragged), the verify recipe (full shuffle, repeat, batch
128), each read across an epoch boundary; then a map that breaks slicing
(the per-element path), `shard`, `repeat(2)` with its per-epoch
reshuffle on both paths, and an exception from a map re-raised through
`prefetch`'s thread.
"""

import itertools

import numpy as np
import pytest

from tfde_tpu.data import datasets as jdatasets
from tfde_tpu.data.pipeline import Dataset as JDataset
from tfde_tpu_torch.data import Dataset
from tfde_tpu_torch.data.pipeline import AutoShardPolicy, _VectorBatched


def _mnist(n_train, flatten):
    (tx, ty), (ex, ey) = jdatasets.mnist(flatten=flatten, n_train=n_train,
                                         n_test=300)
    return (tx, ty), (ex, ey)


def _same(ours, theirs, n=None):
    """The first `n` batches (all when None) of both pipelines are equal,
    and both end together when read whole."""
    a = list(itertools.islice(iter(ours), n))
    b = list(itertools.islice(iter(theirs), n))
    assert len(a) == len(b) and a
    for i, (x, y) in enumerate(zip(a, b)):
        assert len(x) == len(y)
        for u, v in zip(x, y):
            assert u.dtype == v.dtype and u.shape == v.shape, i
            assert np.array_equal(u, v), f"batch {i} differs"
    return a


def _multiworker(ds_cls, x, y, batch):
    def scale(image, label):
        return image.astype("float32"), label

    return (ds_cls.from_tensor_slices((x, y)).map(scale).cache()
            .shuffle(10000, seed=0).repeat().batch(batch, drop_remainder=True))


def test_mnist_multiworker_chain_is_bit_identical():
    """A 10000-element window over 12000 images: the per-element shuffle,
    the cache filled on the first pass and read on the second; 200
    batches of 64 cross the epoch boundary at 187.5."""
    (tx, ty), _ = _mnist(12000, flatten=False)
    ours = _multiworker(Dataset, tx, ty, 64)
    assert not isinstance(ours, _VectorBatched)
    _same(ours, _multiworker(JDataset, tx, ty, 64), 200)


@pytest.mark.parametrize("batch", [128, 100])
def test_estimator_train_input_fn_is_bit_identical(batch):
    """mnist_estimator.input_fn(mode='train'): full shuffle, repeat, batch,
    prefetch(4); at 100 the batches straddle the 1000-image epochs."""
    (tx, ty), _ = _mnist(1000, flatten=True)

    def chain(ds_cls):
        return (ds_cls.from_tensor_slices((tx, ty)).shuffle(len(tx), seed=0)
                .repeat().batch(batch, drop_remainder=True).prefetch(4))

    _same(chain(Dataset), chain(JDataset), 25)


def test_estimator_eval_input_fn_is_bit_identical():
    """mnist_estimator.input_fn(mode='eval'): 300 images in batches of 128,
    the last ragged (44)."""
    _, (ex, ey) = _mnist(64, flatten=True)
    got = _same(Dataset.from_tensor_slices((ex, ey)).batch(128),
                JDataset.from_tensor_slices((ex, ey)).batch(128))
    assert [len(b[0]) for b in got] == [128, 128, 44]


def test_verify_recipe_chain_is_bit_identical():
    (tx, ty), _ = _mnist(1000, flatten=True)

    def chain(ds_cls):
        return (ds_cls.from_tensor_slices((tx, ty)).shuffle(len(tx), seed=0)
                .repeat().batch(128, drop_remainder=True))

    ours = chain(Dataset)
    assert isinstance(ours, _VectorBatched)
    _same(ours, chain(JDataset), 20)


def test_per_element_path_is_bit_identical():
    """A map that reduces over the element (per-row centring) does not
    commute with slicing: both packages verify it on element 0 and fall
    back to the per-element path."""
    rng = np.random.default_rng(0)
    x = rng.random((90, 5), np.float32)
    y = np.arange(90, dtype=np.int64)

    def chain(ds_cls):
        return (ds_cls.from_tensor_slices((x, y))
                .map(lambda a, b: (a - a.mean(), b)).shuffle(90, seed=4)
                .repeat().batch(16, drop_remainder=True))

    ours = chain(Dataset)
    assert not isinstance(ours, _VectorBatched)
    _same(ours, chain(JDataset), 12)


def test_shard_is_bit_identical():
    x = np.arange(50, dtype=np.float32).reshape(25, 2)

    def chain(ds_cls, index):
        return ds_cls.from_tensor_slices((x,)).shard(3, index).batch(4)

    for index in range(3):
        got = _same(chain(Dataset, index), chain(JDataset, index))
        rows = np.concatenate([b[0] for b in got])
        assert np.array_equal(rows, x[index::3])
        assert (Dataset.from_tensor_slices((x,)).shard(3, index).size
                == len(x[index::3]))


@pytest.mark.parametrize("buffer", [40, 10])
def test_repeat_two_reshuffles_each_epoch(buffer):
    """repeat(2) over a seeded shuffle: epoch k uses seed + k, on the
    vectorised path (a full buffer) and the windowed one."""
    x = np.arange(40, dtype=np.int64)

    def chain(ds_cls):
        return ds_cls.from_tensor_slices((x,)).shuffle(buffer, seed=7).repeat(2)

    got = _same(chain(Dataset).batch(40), chain(JDataset).batch(40))
    assert len(got) == 2
    first, second = got[0][0], got[1][0]
    assert sorted(first) == sorted(second) == list(x)
    assert not np.array_equal(first, second)
    _same(chain(Dataset).batch(7), chain(JDataset).batch(7))


def test_map_exception_reaches_the_consumer_through_prefetch():
    x = np.arange(10, dtype=np.float32)

    def boom(v):
        if v == 6:
            raise KeyError("element 6")
        return v

    for ds_cls in (Dataset, JDataset):
        it = iter(ds_cls.from_tensor_slices((x,)).map(boom).prefetch(2))
        seen = [next(it)[0] for _ in range(6)]
        assert seen == list(x[:6])
        with pytest.raises(KeyError, match="element 6"):
            next(it)


def test_policy_names_match_the_jax_package():
    from tfde_tpu.data.pipeline import AutoShardPolicy as JPolicy

    assert [(p.name, p.value) for p in AutoShardPolicy] == [
        (p.name, p.value) for p in JPolicy]
