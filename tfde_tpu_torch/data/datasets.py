"""Synthetic corpora — the one generator of `tfde_tpu/data/datasets.py`
that the training slice needs, copied so that the port never imports the
JAX package. Nothing is downloaded.
"""

from __future__ import annotations

import numpy as np


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
