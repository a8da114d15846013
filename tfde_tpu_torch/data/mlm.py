"""Masked-LM example construction — a copy of `tfde_tpu/data/mlm.py`
(numpy only), so that the port never imports the JAX package: the same
`MlmConfig` and the same generator give the same bits.

The standard BERT recipe: select `mask_rate` of (non-special) positions;
of those, 80% become [MASK], 10% a random token, 10% keep the original.
Labels carry the original ids at selected positions and `ignore_id`
elsewhere; the loss (ops/losses.masked_lm_loss) averages CE over selected
positions only. Masking is host-side integer work: batches reach the
device already masked.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

IGNORE_ID = -100  # conventional "not a target" label


@dataclasses.dataclass(frozen=True)
class MlmConfig:
    vocab_size: int
    mask_id: int
    mask_rate: float = 0.15
    mask_prob: float = 0.8    # -> [MASK]
    random_prob: float = 0.1  # -> uniform random token
    num_special: int = 0      # ids < num_special are never masked


def mask_tokens(
    tokens: np.ndarray, cfg: MlmConfig, rng: np.random.Generator
) -> Tuple[np.ndarray, np.ndarray]:
    """tokens [B,S] int -> (input_ids, labels), labels == IGNORE_ID where
    position is not a prediction target."""
    tokens = np.asarray(tokens)
    u = rng.random(tokens.shape)
    selected = (u < cfg.mask_rate) & (tokens >= cfg.num_special)
    # guarantee >= 1 target per example (degenerate rows skew the loss mean);
    # only eligible (non-special) positions may be forced — rows made
    # entirely of special/padding tokens are left target-free
    eligible = tokens >= cfg.num_special
    none = ~selected.any(axis=1) & eligible.any(axis=1)
    for row in np.flatnonzero(none):
        selected[row, rng.choice(np.flatnonzero(eligible[row]))] = True

    r = rng.random(tokens.shape)
    input_ids = tokens.copy()
    to_mask = selected & (r < cfg.mask_prob)
    to_random = selected & (r >= cfg.mask_prob) & (
        r < cfg.mask_prob + cfg.random_prob
    )
    input_ids[to_mask] = cfg.mask_id
    input_ids[to_random] = rng.integers(
        cfg.num_special, cfg.vocab_size, to_random.sum()
    )
    labels = np.where(selected, tokens, IGNORE_ID).astype(np.int32)
    return input_ids.astype(np.int32), labels
