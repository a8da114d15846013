"""Loss functions — counterpart of `tfde_tpu/ops/losses.py`.

The reference's loss scaling: a sum over examples divided by the global
batch (or, for a masked LM, by the global target count), so that a batch
split over replicas and summed gives the single-replica gradient of the
global mean. Cross-entropy runs in fp32 whatever the logits' dtype, as
the JAX package computes it (optax's integer-label CE on fp32 logits).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def softmax_cross_entropy_with_integer_labels(logits: torch.Tensor,
                                              labels: torch.Tensor
                                              ) -> torch.Tensor:
    """Per-example CE from logits [..., C] and integer labels [...] (an
    [N, 1] column of labels is accepted), in fp32."""
    labels = labels.reshape(logits.shape[:-1]).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels[..., None])[..., 0]


def sparse_categorical_crossentropy(logits: torch.Tensor,
                                    labels: torch.Tensor,
                                    from_logits: bool = True,
                                    global_batch_size: Optional[int] = None
                                    ) -> torch.Tensor:
    """Scalar loss = sum(per-example CE) / global batch (the example count
    when not given). `from_logits=False` takes probabilities, clipped to
    [1e-7, 1 - 1e-7] as Keras does."""
    if not from_logits:
        logits = torch.log(logits.float().clamp(1e-7, 1.0 - 1e-7))
    per_example = softmax_cross_entropy_with_integer_labels(logits, labels)
    denom = (global_batch_size if global_batch_size is not None
             else per_example.numel())
    return per_example.sum() / denom


def masked_lm_loss(logits: torch.Tensor, labels: torch.Tensor,
                   ignore_id: int = -100
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean CE over the target positions, their argmax accuracy). logits
    [B, S, V], labels [B, S] with `ignore_id` marking non-targets; both
    means divide by the target count clamped at 1."""
    weights = (labels != ignore_id).float()
    safe = torch.where(labels == ignore_id, torch.zeros_like(labels), labels)
    per_tok = softmax_cross_entropy_with_integer_labels(logits, safe)
    denom = weights.sum().clamp_min(1.0)
    loss = (per_tok * weights).sum() / denom
    correct = (logits.argmax(dim=-1) == safe).float()
    acc = (correct * weights).sum() / denom
    return loss, acc
