"""Autoregressive generation — counterpart of `tfde_tpu/inference/decode.py`.

- `KVCache`: the explicit cache object that replaces flax's "cache"
  collection — per-layer K/V tensors [B, max_len, Kv, D] in the model's
  compute dtype and one `index` shared by every layer and the position
  table (the JAX `cache_index`/`position_index` leaves always move
  together). `set_index` is the JAX `_set_index_counters` surgery.
- `sample_logits`: repetition penalty, then greedy or temperature with
  the top-k, top-p and min-p filters (`filter_logits`), then a draw from
  an explicit `torch.Generator`.
- `generate`: the solo oracle — one prefill at index 0, then one decode
  step per token with EOS masking; PyTorch runs eagerly, so the JAX scan
  is a Python loop.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from tfde_tpu_torch.utils.devices import resolve_device

_NEG = torch.finfo(torch.float32).min


class KVCache:
    """Per-layer K/V slabs plus the fed-token count.

    `index` is an int (every row at the same position: `generate` and the
    admission prefill, the JAX scalar-index branch) or an int tensor [B]
    (per-row positions: the batcher's decode ticks, the per-row branch).
    The model writes this call's K/V at `index` in place and `advance`s
    it by the call's length."""

    def __init__(self, keys: list, values: list,
                 index: Union[int, torch.Tensor] = 0):
        self.keys = keys
        self.values = values
        self.index = index

    def set_index(self, value: Union[int, torch.Tensor]) -> None:
        """Set the fed-token count of every layer (and of the position
        table): an int for all rows, or a [B] tensor per row."""
        self.index = value

    def advance(self, n: int) -> None:
        self.index = self.index + n

    def scatter_rows(self, rows_cache: "KVCache", rows: torch.Tensor) -> None:
        """Write an R-row cache's K/V into batch rows `rows` [R] in place.
        The index passes through (the decode loop sets it from the host's
        committed counts). Duplicate rows in a ladder-padded wave carry
        identical values, so the result does not depend on write order."""
        for big, small in zip(self.keys + self.values,
                              rows_cache.keys + rows_cache.values):
            big[rows] = small.to(big.dtype)


def validate_budget(model, prompt_len: int, max_new_tokens: int) -> int:
    """prompt_len + max_new_tokens, checked against the learned position
    table's length."""
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
    total = prompt_len + max_new_tokens
    max_pos = getattr(model, "max_position", None)
    if max_pos is not None and total > max_pos:
        raise ValueError(
            f"prompt ({prompt_len}) + max_new_tokens ({max_new_tokens}) = "
            f"{total} exceeds the model's max_position {max_pos}")
    return total


def init_cache(model, batch_size: int, max_len: int) -> KVCache:
    """Zero-filled cache for a [batch_size, max_len] generation budget on
    the model's device, index 0."""
    shape = (batch_size, max_len, model.num_heads, model.head_dim)

    def slab():
        return torch.zeros(shape, dtype=model.dtype, device=model.device)

    return KVCache([slab() for _ in range(model.depth)],
                   [slab() for _ in range(model.depth)], 0)


def filter_logits(logits: torch.Tensor, temperature: float = 1.0,
                  top_k: Optional[int] = None, top_p: Optional[float] = None,
                  min_p: Optional[float] = None,
                  repetition_penalty: float = 1.0,
                  seen: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The logits `sample_logits` draws from at temperature > 0: penalty,
    temperature, then top-k, top-p (nucleus) and min-p, each dropping a
    token by setting its logit to float32's min."""
    logits = _penalize(logits.float(), repetition_penalty, seen)
    logits = logits / temperature
    if top_k is not None and 0 < top_k < logits.shape[-1]:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, _NEG)
    if top_p is not None and 0.0 < top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        # exclusive cumsum: a token stays while the mass strictly above it
        # is below top_p (the top-1 always stays)
        keep = (torch.cumsum(probs, dim=-1) - probs) < top_p
        threshold = torch.where(keep, sorted_logits,
                                torch.full_like(sorted_logits, torch.inf)
                                ).amin(dim=-1, keepdim=True)
        logits = logits.masked_fill(logits < threshold, _NEG)
    if min_p is not None and 0.0 < min_p <= 1.0:
        probs = torch.softmax(logits, dim=-1)
        floor = min_p * probs.amax(dim=-1, keepdim=True)
        logits = logits.masked_fill(probs < floor, _NEG)
    return logits


def _penalize(logits, repetition_penalty, seen):
    if repetition_penalty <= 0.0:
        raise ValueError(
            f"repetition_penalty must be > 0 (1.0 = off), got "
            f"{repetition_penalty}")
    if repetition_penalty == 1.0 or seen is None:
        return logits
    penalized = torch.where(logits > 0, logits / repetition_penalty,
                            logits * repetition_penalty)
    return torch.where(seen, penalized, logits)


def sample_logits(logits: torch.Tensor,
                  generator: Optional[torch.Generator] = None,
                  temperature: float = 1.0, top_k: Optional[int] = None,
                  top_p: Optional[float] = None,
                  min_p: Optional[float] = None,
                  repetition_penalty: float = 1.0,
                  seen: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, V] logits -> [B] int64 token ids. temperature=0 is greedy
    (argmax, first index on ties); otherwise a draw from the filtered
    distribution with `generator`. `seen` [B, V] bool marks ids already in
    the row (prompt included) for the repetition penalty."""
    if temperature == 0.0:
        return torch.argmax(
            _penalize(logits.float(), repetition_penalty, seen), dim=-1)
    probs = torch.softmax(
        filter_logits(logits, temperature, top_k, top_p, min_p,
                      repetition_penalty, seen), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


@torch.no_grad()
def generate(model, prompt, max_new_tokens: int,
             generator: Optional[torch.Generator] = None,
             temperature: float = 0.0, top_k: Optional[int] = None,
             top_p: Optional[float] = None, min_p: Optional[float] = None,
             eos_id: Optional[int] = None, pad_id: int = 0,
             repetition_penalty: float = 1.0, device=None):
    """Generate `max_new_tokens` continuations of `prompt` [B, P].

    Returns (tokens [B, P + max_new_tokens], lengths [B]) as int64 tensors:
    post-EOS positions hold `pad_id`; `lengths[b]` counts the prompt and
    the generated tokens through EOS. Runs on `device` (CUDA by default),
    which must be the model's."""
    device = resolve_device(device)
    if model.device != device:
        raise ValueError(f"model is on {model.device}, generate was asked "
                         f"for {device}")
    prompt = torch.as_tensor(np.asarray(prompt), dtype=torch.int64,
                             device=device)
    b, p = prompt.shape
    total = validate_budget(model, p, max_new_tokens)
    cache = init_cache(model, b, total)
    sample = dict(generator=generator, temperature=temperature, top_k=top_k,
                  top_p=top_p, min_p=min_p,
                  repetition_penalty=repetition_penalty)
    rows = torch.arange(b, device=device)
    seen = None
    if repetition_penalty != 1.0:
        seen = torch.zeros((b, model.vocab_size), dtype=torch.bool,
                           device=device)
        seen[rows[:, None], prompt] = True
    logits = model(prompt, cache=cache)[:, -1]
    tok = sample_logits(logits, seen=seen, **sample)
    if seen is not None:
        seen[rows, tok] = True
    done = (tok == eos_id) if eos_id is not None else torch.zeros(
        b, dtype=torch.bool, device=device)
    new = [tok]
    for _ in range(max_new_tokens - 1):
        logits = model(tok[:, None], cache=cache)[:, -1]
        nxt = sample_logits(logits, seen=seen, **sample)
        if eos_id is not None:
            nxt = torch.where(done, torch.full_like(nxt, pad_id), nxt)
            done = done | (nxt == eos_id)
        if seen is not None:
            seen[rows, nxt] = True
        new.append(nxt)
        tok = nxt
    new_tokens = torch.stack(new, dim=1)
    tokens = torch.cat([prompt, new_tokens], dim=1)
    if eos_id is None:
        lengths = torch.full((b,), total, dtype=torch.int64, device=device)
    else:
        # a position counts while no EOS appeared strictly before it
        is_eos = (new_tokens == eos_id).long()
        seen_before = torch.cumsum(is_eos, dim=1) - is_eos
        lengths = p + (seen_before == 0).long().sum(dim=1)
    return tokens, lengths
