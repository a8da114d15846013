"""The port's ViT (tfde_tpu_torch/models/vit.py), synthetic ImageNet
(data/datasets.imagenet) and the entry point (imagenet_vit.py), held
against the JAX package.

ViT logits (a cls token and `pool='gap'`) on the same weights
(`from_flax_params`: the patch Conv's HWIO kernel, `cls_token`,
`pos_embed`) and the same numpy images: fp32 at 1e-5 relative Frobenius;
a bf16 model within BF16_TOL of the JAX bf16 model, and no farther from
the JAX fp32 model than 1.5 x the JAX bf16 model is. The synthetic
ImageNet and the entry point's input stream (the native loader and the
`Dataset` chain) bit for bit; the entry point at `--tiny --device cpu`.
FSDP training is tests/test_torch_fsdp.py's.
"""

import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from tfde_tpu.data import datasets as jdatasets
from tfde_tpu.models import vit as jvit
from tfde_tpu_torch import imagenet_vit, native
from tfde_tpu_torch.data import datasets
from tfde_tpu_torch.models import vit
from tfde_tpu_torch.models.flax_weights import from_flax_params

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from examples import imagenet_vit as jimagenet_vit  # noqa: E402
from tfde_tpu_torch.testing import one_thread

#: one intra-op torch thread for the module (`testing.one_thread`)
_one_thread = pytest.fixture(autouse=True, scope="module")(one_thread)

BF16_TOL = 1e-2


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _images(n=3, side=32):
    return np.random.default_rng(0).random((n, side, side, 3), np.float32)


@functools.cache
def _params(pool):
    params = jvit.vit_tiny_test(pool=pool).init(
        jax.random.key(1), jnp.asarray(_images()), train=False)["params"]
    return jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("pool", ["cls", "gap"])
def test_vit_logits_match_jax(pool):
    x = _images()
    params = _params(pool)
    assert ("cls_token" in params) == (pool == "cls")
    want = np.asarray(jvit.vit_tiny_test(pool=pool).apply(
        {"params": params}, jnp.asarray(x)))
    model = vit.vit_tiny_test(pool=pool, device="cpu")
    model.load_state_dict(from_flax_params(params))
    got = model(torch.as_tensor(x)).detach().numpy()
    assert got.shape == (3, 10) and got.dtype == np.float32
    assert _rel(got, want) <= 1e-5


def test_vit_bf16_logits_match_jax():
    cfg = dict(num_classes=10, patch_size=4, embed_dim=128, depth=2,
               num_heads=2, mlp_dim=256)
    x = _images()
    jm = jvit.ViT(**cfg)
    params = jax.tree.map(np.asarray, jm.init(
        jax.random.key(2), jnp.asarray(x))["params"])
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    want32 = np.asarray(jvit.ViT(**cfg, dtype=jnp.float32).apply(
        {"params": params}, jnp.asarray(x)))
    model = vit.ViT(**cfg, image_size=32, device="cpu")
    model.load_state_dict(from_flax_params(params))
    got = model(torch.as_tensor(x)).detach().numpy()
    print(f"bf16: port vs JAX {_rel(got, want):.3e}; port vs JAX fp32 "
          f"{_rel(got, want32):.3e}; JAX bf16 vs fp32 "
          f"{_rel(want, want32):.3e}")
    assert got.dtype == np.float32
    assert _rel(got, want) <= BF16_TOL
    assert _rel(got, want32) <= 1.5 * _rel(want, want32)


class _OnMeta(TorchFunctionMode):
    """Every tensor a factory makes lands on the meta device whatever
    device it names: a full-width model's shapes without its storage."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if kwargs.get("device") is not None:
            kwargs = {**kwargs, "device": "meta"}
        return func(*args, **kwargs)


def test_vit_b16_parameter_count():
    # the canonical ViT-B/16 with a 1000-class head (tests/test_vit.py)
    with _OnMeta():
        model = vit.ViT_B16(num_classes=1000, device="cpu")
    assert all(p.is_meta for p in model.parameters())
    assert sum(p.numel() for p in model.parameters()) == 86_567_656
    assert model.pos_embed.shape == (1, 197, 768)


def test_unported_fields_and_bad_sizes_raise():
    # a field of the JAX decoder that the JAX ViT does not have
    with pytest.raises(TypeError, match="use_bias"):
        vit.vit_tiny_test(device="cpu", use_bias=False)
    with pytest.raises(ValueError, match="patch_size"):
        vit.vit_tiny_test(device="cpu", image_size=30)
    with pytest.raises(ValueError, match="pool"):
        vit.vit_tiny_test(device="cpu", pool="max")


@pytest.mark.parametrize("side,classes", [(32, 10), (48, 1000)])
def test_synthetic_imagenet_is_the_jax_packages(side, classes):
    got = datasets.imagenet(n_train=24, n_test=5, side=side,
                            num_classes=classes)
    want = jdatasets.imagenet(n_train=24, n_test=5, side=side,
                              num_classes=classes)
    for g_split, w_split in zip(got, want, strict=True):
        for g, w in zip(g_split, w_split, strict=True):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
    assert got[0][0].shape == (24, side, side, 3)


@pytest.mark.parametrize("use_native", [True, False])
def test_entry_point_stream_is_the_jax_examples(use_native):
    if use_native and not native.available():
        pytest.fail("the native loader's library did not build")
    got = imagenet_vit.make_train_dataset(8, 32, 40, 10,
                                          use_native=use_native)
    want = jimagenet_vit.make_train_dataset(8, 32, 40, 10,
                                            use_native=use_native)
    for _, g, w in zip(range(7), got, want):  # past one epoch of 5
        np.testing.assert_array_equal(g[0], w[0])
        np.testing.assert_array_equal(g[1], w[1])


def test_entry_point_trains_the_tiny_model_on_the_cpu():
    state = imagenet_vit.main([
        "--tiny", "--device", "cpu", "--image-size", "32", "--max-steps",
        "2", "--batch-size", "16", "--train-examples", "64", "--remat",
        "dots"])
    assert state.step == 2
    with pytest.raises(RuntimeError, match="CUDA"):
        imagenet_vit.main(["--tiny", "--max-steps", "1"])
    with pytest.raises(SystemExit):
        imagenet_vit.main(["--tiny", "--device", "cpu", "--fake-devices",
                           "8"])
