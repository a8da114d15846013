"""Datasets — the generators of `tfde_tpu/data/datasets.py` that the
ported paths need, copied so that the port never imports the JAX
package: the synthetic token corpus, MNIST, CIFAR-10 (`cifar10` :131,
`_load_npz` :116) and ImageNet (`imagenet` :147). Each image set is a
local ``.npz`` where `_find` finds
one, else the deterministic synthetic stand-in, bit for bit the JAX
package's arrays for the same sizes. Nothing is downloaded.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Tuple

import numpy as np

from tfde_tpu_torch import knobs

Arrays = Tuple[Tuple[np.ndarray, np.ndarray], Tuple[np.ndarray, np.ndarray]]

_SEARCH_DIRS = [
    lambda: knobs.env_str("TFDE_DATA_DIR"),
    lambda: os.path.expanduser("~/.keras/datasets"),
]


def _find(name: str):
    for get in _SEARCH_DIRS:
        d = get()
        if d and (Path(d) / name).exists():
            return Path(d) / name
    return None


def _glyph_templates(num_classes: int, side: int, rng: np.random.Generator) -> np.ndarray:
    """Distinct smooth per-class templates: a few random 2-D cosine modes
    per class, reproducible from the seed."""
    yy, xx = np.mgrid[0:side, 0:side] / side
    t = np.zeros((num_classes, side, side), np.float32)
    for c in range(num_classes):
        for _ in range(4):
            fx, fy = rng.integers(1, 5, size=2)
            phase = rng.uniform(0, 2 * np.pi, size=2)
            t[c] += np.cos(2 * np.pi * fx * xx + phase[0]) * np.cos(
                2 * np.pi * fy * yy + phase[1]
            )
        t[c] -= t[c].min()
        t[c] /= t[c].max() + 1e-8
    return t


def _synthetic_images(
    n_train: int, n_test: int, side: int, num_classes: int, seed: int, channels: int = 0
) -> Arrays:
    rng = np.random.default_rng(seed)
    templates = _glyph_templates(num_classes, side, rng)

    def make(n, rng):
        labels = rng.integers(0, num_classes, size=n).astype(np.int64)
        imgs = templates[labels].copy()
        # per-example jitter: random shift ±2 px and gaussian noise
        shifts = rng.integers(-2, 3, size=(n, 2))
        imgs = np.stack(
            [np.roll(np.roll(im, s0, 0), s1, 1) for im, (s0, s1) in zip(imgs, shifts)]
        )
        imgs += rng.normal(0, 0.25, imgs.shape).astype(np.float32)
        imgs = np.clip(imgs, 0, 1).astype(np.float32)
        if channels:
            imgs = np.repeat(imgs[..., None], channels, axis=-1)
        return imgs, labels.reshape(-1, 1)

    return make(n_train, rng), make(n_test, rng)


def mnist(flatten: bool = True, n_train: int = 60000, n_test: int = 10000) -> Arrays:
    """MNIST (or its synthetic stand-in): images float in [0, 1], labels
    int64 [N, 1]. `flatten=True` gives [N, 784] images, else
    [N, 28, 28, 1]."""
    path = _find("mnist.npz")
    if path is not None:
        with np.load(path) as d:
            tr_x, tr_y = d["x_train"], d["y_train"]
            te_x, te_y = d["x_test"], d["y_test"]
        tr_x = (tr_x / 255.0).astype(np.float32)
        te_x = (te_x / 255.0).astype(np.float32)
        tr_y = np.asarray(tr_y).astype(np.int64).reshape(-1, 1)
        te_y = np.asarray(te_y).astype(np.int64).reshape(-1, 1)
        tr_x = tr_x[..., None]
        te_x = te_x[..., None]
        train, test = (tr_x[:n_train], tr_y[:n_train]), (te_x[:n_test], te_y[:n_test])
    else:
        train, test = _synthetic_images(n_train, n_test, 28, 10, seed=0, channels=1)
    if flatten:
        train = (train[0].reshape(len(train[0]), -1), train[1])
        test = (test[0].reshape(len(test[0]), -1), test[1])
    return train, test


def _load_npz(path, n_train: int, n_test: int) -> Arrays:
    """The standard npz layout (x_train/y_train/x_test/y_test, uint8
    images) -> float [0, 1] images, int64 [N, 1] labels."""
    with np.load(path) as d:
        tr = (
            (d["x_train"] / 255.0).astype(np.float32)[:n_train],
            np.asarray(d["y_train"]).astype(np.int64).reshape(-1, 1)[:n_train],
        )
        te = (
            (d["x_test"] / 255.0).astype(np.float32)[:n_test],
            np.asarray(d["y_test"]).astype(np.int64).reshape(-1, 1)[:n_test],
        )
    return tr, te


def cifar10(n_train: int = 50000, n_test: int = 10000) -> Arrays:
    """CIFAR-10: [N, 32, 32, 3] float images in [0, 1], int64 labels
    [N, 1]. A local ``cifar10.npz`` where `_find` finds one; else the
    synthetic stand-in: 32x32 class templates from seed 1, one channel
    repeated three times."""
    path = _find("cifar10.npz")
    if path is not None:
        return _load_npz(path, n_train, n_test)
    train, test = _synthetic_images(n_train, n_test, 32, 10, seed=1)
    tr = np.repeat(train[0][..., None], 3, axis=-1), train[1]
    te = np.repeat(test[0][..., None], 3, axis=-1), test[1]
    return tr, te


def imagenet(n_train: int = 10000, n_test: int = 1000, side: int = 224,
             num_classes: int = 1000) -> Arrays:
    """ImageNet-shaped data for ViT-B/16: [N, side, side, 3] float images
    in [0, 1], int64 labels [N, 1]. A local ``imagenet.npz`` where `_find`
    finds one of the requested side and classes; else the synthetic
    stand-in: class templates from seed 3 at `side` px, the channel
    repeated three times by the generator."""
    path = _find("imagenet.npz")
    if path is not None:
        tr, te = _load_npz(path, n_train, n_test)
        if tr[0].shape[1] == side and tr[1].max() < num_classes:
            return tr, te
        import logging

        logging.getLogger(__name__).warning(
            "%s is %dpx with labels up to %d but %dpx/%d classes were "
            "requested; using the synthetic generator instead",
            path, tr[0].shape[1], int(tr[1].max()), side, num_classes,
        )
    return _synthetic_images(n_train, n_test, side, num_classes, seed=3,
                             channels=3)


def synthetic_tokens(n: int, seq_len: int, vocab: int = 30522,
                     seed: int = 2) -> np.ndarray:
    """[n, seq_len] int32 token ids, made from `seed` with numpy: a
    Markov-ish stream (each token follows its predecessor's fixed
    successor with probability 0.7) so a language model has structure to
    learn. The same seed gives the JAX package's tokens, bit for bit."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, vocab, size=(n, seq_len), dtype=np.int32)
    succ = (np.arange(vocab, dtype=np.int32) * 31 + 7) % vocab
    for t in range(1, seq_len):
        follow = rng.random((n,)) < 0.7
        base[follow, t] = succ[base[follow, t - 1]]
    return base
