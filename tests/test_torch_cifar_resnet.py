"""The port's CIFAR-10 ResNet-50 entry point (tfde_tpu_torch.cifar10_resnet)
against `examples/cifar10_resnet.py`, on the CPU.

- CIFAR-10's synthetic stand-in is the JAX package's, bit for bit.
- `augment` gives the JAX example's arrays bit for bit for the same
  generator state.
- `make_train_dataset` on both paths (the native loader, the Python
  `Dataset`) yields the JAX example's batches bit for bit, at a reduced
  dataset size (both packages' `datasets.cifar10` cut to 640 rows: the
  stream's code is the same at any size, and the stand-in at full size
  costs ~5 s a package).
- `main([... "--device", "cpu"])` trains one step as a user runs it
  (ResNet-50 at full width, batch 8, on the reduced dataset: ~4 s
  serially) and logs that the native loader fed it; the JAX example's
  ``--fake-devices`` is an argparse error.
"""

import functools
import logging

import numpy as np
import pytest

from examples import cifar10_resnet as jexample
from tfde_tpu.data import datasets as jdatasets
from tfde_tpu_torch import cifar10_resnet, native
from tfde_tpu_torch.data import datasets
from tfde_tpu_torch.testing import one_thread

#: one intra-op torch thread for the module (`testing.one_thread`)
_one_thread = pytest.fixture(autouse=True, scope="module")(one_thread)


def test_synthetic_cifar10_equals_the_jax_package():
    (tx, ty), (ex, ey) = datasets.cifar10(n_train=1000, n_test=200)
    (jx, jy), (jex, jey) = jdatasets.cifar10(n_train=1000, n_test=200)
    assert tx.shape == (1000, 32, 32, 3) and tx.dtype == np.float32
    assert ty.shape == (1000, 1) and ty.dtype == np.int64
    for a, b in ((tx, jx), (ty, jy), (ex, jex), (ey, jey)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_augment_equals_the_jax_example():
    images = np.random.default_rng(0).random((16, 32, 32, 3),
                                             dtype=np.float32)
    ours = cifar10_resnet.augment(np.random.default_rng(3), images)
    theirs = jexample.augment(np.random.default_rng(3), images)
    assert ours.shape == images.shape and ours.dtype == images.dtype
    assert ours.tobytes() == theirs.tobytes()
    assert not np.array_equal(ours, images)


@pytest.fixture
def small_cifar(monkeypatch):
    for mod in (datasets, jdatasets):
        monkeypatch.setattr(mod, "cifar10", functools.partial(
            mod.cifar10, n_train=640, n_test=16))


@pytest.mark.parametrize("use_native", [True, False])
def test_train_dataset_equals_the_jax_example(small_cifar, use_native):
    assert native.available()
    ours = iter(cifar10_resnet.make_train_dataset(64, seed=4,
                                                  use_native=use_native))
    theirs = iter(jexample.make_train_dataset(64, seed=4,
                                              use_native=use_native))
    for _ in range(15):  # 1.5 passes over the 640 rows
        a, b = next(ours), next(theirs)
        assert a[0].shape == (64, 32, 32, 3) and a[1].shape == (64, 1)
        for u, v in zip(a, b, strict=True):
            assert u.dtype == v.dtype and u.tobytes() == v.tobytes()


def test_main_trains_one_step_on_the_cpu(small_cifar, caplog):
    caplog.set_level(logging.INFO)
    state = cifar10_resnet.main(["--device", "cpu", "--max-steps", "1",
                                 "--warmup-steps", "0", "--batch-size", "8"])
    assert state.step == 1
    assert sum(p.numel() for p in state.model.parameters()) == 23_520_842
    assert "input: the native loader" in caplog.text
    assert "done at step 1" in caplog.text


def test_main_refuses_the_jax_only_flag():
    with pytest.raises(SystemExit):
        cifar10_resnet.main(["--device", "cpu", "--fake-devices", "8"])
