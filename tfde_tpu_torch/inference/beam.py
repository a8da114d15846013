"""Beam search — counterpart of `tfde_tpu/inference/beam.py`.

The deterministic decoding mode beside sampling `generate`: keep the
`num_beams` highest joint-log-prob continuations of each prompt, extending
all of them one token a step through the same cached decode forward.

Beams ride the batch dimension: the prompt prefills once on [B*K, P]
(index 0: the flash kernel on a CUDA tensor), and every step feeds [B*K, 1]
tokens, scores all K*V single-token extensions of a row and keeps the top
K; the cache follows its beams with one `index_select` of every plane
along the batch dimension (`KVCache.select_rows`). A beam that has
emitted `eos_id` is finished: it extends only with `pad_id` at zero cost
(`_NEG` elsewhere), so its joint score freezes while it keeps competing
for a slot. The final ranking divides each joint log-prob by `length **
length_penalty` (0.0: no normalisation). A model with a sliding window
decodes on the rolling cache (`decode.init_cache(..., rolling=True)`), as
in JAX. PyTorch runs eagerly, so the JAX scan is a Python loop.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from tfde_tpu_torch.inference.decode import (
    init_cache, remat_off, validate_budget)
from tfde_tpu_torch.utils.devices import resolve_device

_NEG = -1e9  # an additive "impossible": finite, so the sums stay clean


@torch.no_grad()
def beam_search(model, prompt, max_new_tokens: int, num_beams: int = 4,
                length_penalty: float = 0.6, eos_id: Optional[int] = None,
                pad_id: int = 0, device=None):
    """[B, P] int prompt -> (tokens [B, K, P + max_new_tokens] int64,
    scores [B, K] fp32, lengths [B, K] int64), beams sorted best-first by
    length-normalised joint log-prob; `tokens[:, 0]` is the decode result
    and `lengths` counts the prompt and each beam's tokens through its
    EOS (pad after). Runs on `device` (CUDA by default), which must be the
    model's."""
    if num_beams < 1:
        raise ValueError(f"num_beams must be >= 1, got {num_beams}")
    device = resolve_device(device)
    if model.device != device:
        raise ValueError(f"model is on {model.device}, beam_search was "
                         f"asked for {device}")
    prompt = torch.as_tensor(np.asarray(prompt), dtype=torch.int64,
                             device=device)
    b, p = prompt.shape
    k = num_beams
    with remat_off(model):
        total = validate_budget(model, p, max_new_tokens)
        cache = init_cache(model, b * k, total, rolling=True)
        hidden = model.hidden(prompt.repeat_interleave(k, dim=0), cache=cache)
        logp = torch.log_softmax(model.head(hidden[:, -1]), dim=-1)
        vocab = logp.shape[-1]
        # the K beams of a row are still identical: seed them with the top
        # K tokens of the ROW, not of K copies
        scores, tok = torch.topk(logp.view(b, k, vocab)[:, 0], k, dim=-1)
        seqs = torch.zeros((b, k, max_new_tokens), dtype=torch.int64,
                           device=device)
        seqs[:, :, 0] = tok
        finished = ((tok == eos_id) if eos_id is not None
                    else torch.zeros((b, k), dtype=torch.bool, device=device))
        pad_only = torch.full((vocab,), _NEG, device=device)
        pad_only[pad_id] = 0.0
        base = torch.arange(b, device=device)[:, None] * k
        for t in range(1, max_new_tokens):
            logits = model(tok.reshape(-1, 1), cache=cache)[:, -1]
            logp = torch.log_softmax(logits, dim=-1).view(b, k, vocab)
            if eos_id is not None:
                logp = torch.where(finished[:, :, None], pad_only, logp)
            cand = scores[:, :, None] + logp
            scores, flat = torch.topk(cand.view(b, k * vocab), k, dim=-1)
            beam = flat // vocab  # [B, K] source beam
            tok = flat % vocab
            cache.select_rows((beam + base).reshape(-1))
            seqs = torch.gather(seqs, 1, beam[:, :, None].expand(
                -1, -1, max_new_tokens)).clone()
            seqs[:, :, t] = tok
            if eos_id is not None:
                finished = torch.gather(finished, 1, beam) | (tok == eos_id)
    if eos_id is None:
        lengths = torch.full((b, k), max_new_tokens, dtype=torch.int64,
                             device=device)
    else:
        # a position counts while no EOS appeared strictly before it
        is_eos = (seqs == eos_id).long()
        alive = (torch.cumsum(is_eos, dim=-1) - is_eos) == 0
        lengths = alive.long().sum(dim=-1)
        seqs = torch.where(alive, seqs, pad_id)
    norm = lengths.float() ** length_penalty
    final = scores / torch.clamp(norm, min=1.0)
    order = torch.argsort(-final, dim=-1, stable=True)
    seqs = torch.gather(seqs, 1, order[:, :, None].expand(
        -1, -1, max_new_tokens))
    tokens = torch.cat([prompt[:, None].expand(b, k, p), seqs], dim=-1)
    return (tokens, torch.gather(final, 1, order),
            p + torch.gather(lengths, 1, order))
