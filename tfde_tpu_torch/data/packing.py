"""Sequence packing for causal-LM training — counterpart of
`tfde_tpu/data/packing.py`: variable-length documents packed into fixed
[B, S] rows with block-diagonal attention.

The packed batch is an ordinary [B, S] token array plus a same-shaped
segment-id plane; the model composes the segment mask with its causal
triangle (`models/gpt.GPT(segment_ids=...)`), and the loss masks the
predictions that cross a document boundary. Under rope the packed forward
is exact per document. The segment mask sends attention to the reference
einsum, as in JAX (the flash kernels take no mask): packing is a
host-side throughput lever, not a kernel-side one.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from tfde_tpu_torch.ops.losses import masked_lm_loss

IGNORE_ID = -100


def pack_documents(docs: Sequence[np.ndarray], seq_len: int,
                   pad_id: int = 0, max_open_rows: int = 1024
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Greedy first-fit packing over a bounded pool of open rows: each
    document lands whole in the first open row with room (a document
    longer than seq_len is split into seq_len chunks first). Returns
    (tokens [N, S], segment_ids [N, S]) int32, segment ids 1..k per row
    and 0 marking padding. Every input token appears once, in order,
    within its segment. At most `max_open_rows` partly filled rows stay
    candidates (the oldest closes first past the cap; a full row closes
    at once), so packing costs O(pieces * max_open_rows)."""
    if seq_len < 1:
        raise ValueError(f"seq_len must be >= 1, got {seq_len}")
    pieces: List[np.ndarray] = []
    for d in docs:
        d = np.asarray(d)
        if d.ndim != 1:
            raise ValueError(f"each document must be a 1-D token array, "
                             f"got shape {d.shape}")
        for start in range(0, len(d), seq_len):
            pieces.append(d[start:start + seq_len])

    rows: List[List[np.ndarray]] = []
    space: List[int] = []
    open_rows: List[int] = []  # indices into rows/space, oldest first
    for p in pieces:
        for j, i in enumerate(open_rows):
            if len(p) <= space[i]:
                rows[i].append(p)
                space[i] -= len(p)
                if space[i] == 0:
                    open_rows.pop(j)
                break
        else:
            rows.append([p])
            space.append(seq_len - len(p))
            if space[-1] > 0:
                open_rows.append(len(rows) - 1)
                if len(open_rows) > max_open_rows:
                    open_rows.pop(0)

    n = max(len(rows), 1)
    tokens = np.full((n, seq_len), pad_id, dtype=np.int32)
    segment_ids = np.zeros((n, seq_len), dtype=np.int32)
    for i, row in enumerate(rows):
        at = 0
        for seg, p in enumerate(row, start=1):
            tokens[i, at:at + len(p)] = p
            segment_ids[i, at:at + len(p)] = seg
            at += len(p)
    return tokens, segment_ids


def valid_targets(segment_ids):
    """[B, S-1] bool: position i+1 is a valid next-token target of
    position i (same segment, not padding). The one definition of the
    boundary rule, for numpy arrays and tensors alike."""
    seg = segment_ids
    return (seg[:, 1:] > 0) & (seg[:, 1:] == seg[:, :-1])


def packed_labels(tokens: np.ndarray, segment_ids: np.ndarray,
                  ignore_id: int = IGNORE_ID) -> np.ndarray:
    """Next-token labels of a packed batch aligned to the shifted loss
    (label[i] is the target of position i-1): the first token of every
    segment and all padding are `ignore_id`."""
    seg = np.asarray(segment_ids)
    labels = np.asarray(tokens).astype(np.int32)
    valid = np.zeros_like(seg, dtype=bool)
    valid[:, 1:] = valid_targets(seg)
    labels[~valid] = ignore_id
    return labels


def packed_next_token_loss(model, batch,
                           generator: Optional[torch.Generator] = None):
    """(loss, metrics) for `make_custom_train_step` over packed batches
    (tokens, segment_ids): the shifted CE over in-segment positions only,
    with ``packed_accuracy`` and ``grad_weight``, the target count, so
    that accumulation and data parallelism reproduce the full-batch
    update on unevenly packed microbatches. A routed (MoE) GPT's losses
    join the objective and the metrics as in `models.gpt.next_token_loss`.
    The GPT has no dropout, so `generator` draws nothing."""
    from tfde_tpu_torch.models.moe import sown_losses_by_name

    tokens, segment_ids = batch
    sown = {}
    logits = model(tokens, segment_ids=segment_ids, losses=sown)
    valid = valid_targets(segment_ids.to(torch.int32))
    labels = torch.where(valid, tokens[:, 1:].long(),
                         torch.full_like(tokens[:, 1:].long(), IGNORE_ID))
    loss, acc = masked_lm_loss(logits[:, :-1], labels, IGNORE_ID)
    metrics = {"packed_accuracy": acc, "grad_weight": valid.float().sum()}
    for name, total in sown_losses_by_name(sown).items():
        loss = loss + total
        metrics[name] = total
    return loss, metrics
