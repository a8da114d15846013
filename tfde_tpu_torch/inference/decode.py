"""Autoregressive generation — counterpart of `tfde_tpu/inference/decode.py`.

- `KVCache`: the explicit cache object that replaces flax's "cache"
  collection — per-layer K/V tensors [B, max_len, Kv, D] in the model's
  compute dtype and one `index` shared by every layer and the position
  table (the JAX `cache_index`/`position_index` leaves always move
  together). `set_index` is the JAX `_set_index_counters` surgery.
  `PagedKVCache` is the paged layout (inference/paged.py): per-layer
  pools [num_blocks, block, Kv, D] and one [B, nmax] block table
  (`init_cache(..., paged_blocks=, kv_block=)`). With
  `init_cache(..., kv_quant='int8')` either layout holds int8 payloads
  and fp32 scale planes (`key_scales`/`value_scales`: [B, max_len, Kv]
  or [num_blocks, block, Kv] a layer; ops/quant.kv_quantize). Shipped
  K/V (the role split's primed hand-off) lands with
  `KVCache.land_planes` (rows) or `PagedKVCache.land_blocks` (pool
  blocks), each held to the cache's layout by `check_planes`.
- `sample_logits`: repetition penalty, then greedy or temperature with
  the top-k, top-p and min-p filters (`filter_logits`), then a draw from
  an explicit `torch.Generator`, or, given `gumbel_noise`, the Gumbel-max
  draw argmax(filtered logits + noise).
- `gumbel_noise`: Gumbel(0, 1) noise that is a pure function of (seed,
  step, row, token id) — a counter-based hash, no generator state — so a
  traced program takes the seed as an input (export/generative.py), as
  the JAX package's exported decode takes its PRNG seed.
- `generate`: the solo oracle — one prefill at index 0, then one decode
  step per token with EOS masking; PyTorch runs eagerly, so the JAX scan
  is a Python loop over `decode_token`, the decode tick a generative
  artifact exports (export/generative.py). Sampling draws from a
  `generator` or, with `seed`, from `gumbel_noise`: the same seed gives
  the same tokens in process and from an exported artifact.
- `generate_ragged`: `generate` for right-padded prompts of different
  lengths: the shortest prefix prefills, then each row's prompt tail is
  teacher-forced one token a step, so the cache never holds padding.
- The rolling cache (`init_cache(..., rolling=True)` on a model with a
  sliding window; `KVCache.rolling`): each windowed layer's planes hold
  min(budget, window) slots, the token at position p in slot p mod slots
  (models/transformer.MultiHeadAttention._rolling_attention). `generate`,
  `generate_ragged` and inference/beam.py decode on it, as in JAX; the
  paths that rewind (speculative decoding, the batchers) and the exported
  decode keep the full-budget cache. A rolling cache's index stays an
  int: JAX's rolling layer refuses per-row indices, and so does the
  port's.
- `remat_off`: serves a remat-trained model (the JAX `_decode_clone`'s
  remat=False); decode itself refuses remat.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Union

import numpy as np
import torch

from tfde_tpu_torch.models.transformer import Encoder
from tfde_tpu_torch.utils.devices import resolve_device

_NEG = torch.finfo(torch.float32).min


class KVCache:
    """Per-layer K/V slabs plus the fed-token count.

    `index` is an int (every row at the same position: `generate` and the
    admission prefill, the JAX scalar-index branch) or an int tensor [B]
    (per-row positions: the batcher's decode ticks, the per-row branch).
    The model writes this call's K/V at `index` in place and `advance`s
    it by the call's length. An int8 cache (`quantized`) carries fp32
    scale planes beside its int8 payloads, one a layer and k/v (the JAX
    `cached_key_scale`/`cached_value_scale` leaves); an fp cache has
    None there."""

    def __init__(self, keys: list, values: list,
                 index: Union[int, torch.Tensor] = 0,
                 key_scales: Optional[list] = None,
                 value_scales: Optional[list] = None,
                 rolling: bool = False):
        if (key_scales is None) != (value_scales is None):
            raise ValueError("an int8 cache needs both scale planes")
        self.keys = keys
        self.values = values
        self.index = index
        self.key_scales = key_scales
        self.value_scales = value_scales
        #: the windowed layers' planes are rolling slots (`init_cache(...,
        #: rolling=True)`): slot = position mod the plane's length
        self.rolling = rolling

    @property
    def quantized(self) -> bool:
        """True for an int8 cache (payload + scale planes)."""
        return self.key_scales is not None

    def planes(self) -> dict:
        """Every K/V tensor of the cache by (layer, name): 'k' and 'v',
        and for an int8 cache 'k_scale' and 'v_scale' (the index and a
        paged block table are not planes)."""
        out = {}
        for layer in range(len(self.keys)):
            out[(layer, "k")] = self.keys[layer]
            out[(layer, "v")] = self.values[layer]
            if self.quantized:
                out[(layer, "k_scale")] = self.key_scales[layer]
                out[(layer, "v_scale")] = self.value_scales[layer]
        return out

    def set_index(self, value: Union[int, torch.Tensor]) -> None:
        """Set the fed-token count of every layer (and of the position
        table): an int for all rows, or a [B] tensor per row."""
        self.index = value

    def advance(self, n: int) -> None:
        self.index = self.index + n

    def select_rows(self, rows: torch.Tensor) -> None:
        """Make row i of every plane the old row `rows[i]` ([B'] int64 on
        the cache's device): one `index_select` along dim 0 a plane (beam
        search's reorder, the JAX `_gather_beams`). A [B] index follows
        its rows; an int index is every row's."""
        for planes in (self.keys, self.values, self.key_scales,
                       self.value_scales):
            for i, plane in enumerate(planes or ()):
                planes[i] = plane.index_select(0, rows)
        if isinstance(self.index, torch.Tensor):
            self.index = self.index.index_select(0, rows)

    def scatter_rows(self, rows_cache: "KVCache", rows: torch.Tensor) -> None:
        """Write an R-row cache's K/V into batch rows `rows` [R] in place.
        The index passes through (the decode loop sets it from the host's
        committed counts). Duplicate rows in a ladder-padded wave carry
        identical values, so the result does not depend on write order."""
        if rows_cache.quantized != self.quantized:
            raise ValueError("scatter_rows between an int8 and an fp cache: "
                             "a cast would truncate the payload")
        mine, theirs = self.planes(), rows_cache.planes()
        for name, big in mine.items():
            small = theirs[name]
            if small.dtype != big.dtype:
                raise ValueError(f"scatter_rows: plane {name} is "
                                 f"{small.dtype}, the cache's {big.dtype}")
            big[rows] = small

    def land_planes(self, planes: dict, rows: torch.Tensor) -> None:
        """Write shipped K/V (a primed hand-off: `planes` maps each of this
        cache's plane names to [R, P, ...] on its device, P <= max_len)
        into cells [0, P) of batch rows `rows` [R], in place. Duplicate
        rows carry identical values. A payload of another layout raises
        (`check_planes`)."""
        check_planes(self, planes, lead=2)
        for name, big in self.planes().items():
            seg = planes[name]
            big[rows, :seg.shape[1]] = seg


def check_planes(cache: KVCache, planes: dict, lead: int) -> None:
    """Hold shipped planes to `cache`'s layout: the same plane names
    (`KVCache.planes()`), each in the cache's dtype, with the cache's
    per-cell dims [Kv, D] (a scale plane: [Kv]) after `lead` leading
    dims (one primed request's [P, ...]: 1; a dense wave's [R, P, ...]:
    2; a paged wave's [R, NB, block, ...]: 3). Raises ValueError
    otherwise, where JAX casts: a full-precision payload would truncate
    into an int8 cache, and int8 without its scale planes cannot be
    read."""
    mine = cache.planes()
    if set(planes) != set(mine):
        missing = sorted(set(mine) - set(planes))
        extra = sorted(set(planes) - set(mine))
        raise ValueError(
            f"shipped K/V planes do not match the cache's "
            f"({'int8' if cache.quantized else 'fp'}): missing "
            f"{missing[:4]}{' ...' if len(missing) > 4 else ''}, "
            f"unexpected {extra[:4]}{' ...' if len(extra) > 4 else ''}")
    for name, big in mine.items():
        seg = planes[name]
        if seg.dtype != big.dtype:
            raise ValueError(f"shipped plane {name} is {seg.dtype}, the "
                             f"cache's {big.dtype}: a cast would change it")
        if tuple(seg.shape[lead:]) != tuple(big.shape[2:]):
            raise ValueError(
                f"shipped plane {name} has cells {tuple(seg.shape[lead:])},"
                f" the cache's {tuple(big.shape[2:])}")


class PagedKVCache(KVCache):
    """The paged layout: per-layer K/V pools [num_blocks, block, Kv, D]
    shared by every row, one [B, nmax] int64 block table on the device
    (row r's positions [s*block, (s+1)*block) live in pool block
    `table[r, s]`; unallocated slots hold the null block 0) and the
    fed-token count, an int or a [B] tensor. nmax = ceil((max_len + 1) /
    block): the decode scan writes one past a frozen row's committed
    count. The model writes and gathers through the table
    (models/transformer.MultiHeadAttention._paged_attention)."""

    def __init__(self, keys: list, values: list, table: torch.Tensor,
                 block: int, index: Union[int, torch.Tensor] = 0,
                 key_scales: Optional[list] = None,
                 value_scales: Optional[list] = None):
        super().__init__(keys, values, index, key_scales, value_scales)
        self.table = table
        self.block = int(block)

    def select_rows(self, rows: torch.Tensor) -> None:
        raise ValueError("a paged cache's rows share its pools: reorder "
                         "the block table, not the planes")

    def land_blocks(self, planes: dict, blocks: torch.Tensor) -> None:
        """Write shipped K/V re-chunked to blocks (`planes`: each plane
        name to [R, NB, block, ...] on the device) into pool blocks
        `blocks` [R, NB], in place. Slots past a row's prompt blocks name
        the null block and carry zeros, so duplicate writes are
        identical. A payload of another layout raises (`check_planes`)."""
        check_planes(self, planes, lead=3)
        for name, pool in self.planes().items():
            seg = planes[name]
            if seg.shape[2] != self.block:
                raise ValueError(f"shipped plane {name} is chunked to "
                                 f"{seg.shape[2]}-cell blocks, the pool "
                                 f"to {self.block}")
            pool[blocks] = seg


def validate_budget(model, prompt_len: int, max_new_tokens: int) -> int:
    """prompt_len + max_new_tokens, checked against the learned position
    table's length (a rotary model has no table: its budget is bounded
    by memory only)."""
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
    total = prompt_len + max_new_tokens
    max_pos = getattr(model, "max_position", None)
    if (max_pos is not None and total > max_pos
            and getattr(model, "position", "learned") != "rope"):
        raise ValueError(
            f"prompt ({prompt_len}) + max_new_tokens ({max_new_tokens}) = "
            f"{total} exceeds the model's max_position {max_pos}")
    return total


def resolve_kv_quant(model, kv_quant: Optional[str] = None,
                     rolling: bool = False) -> Optional[str]:
    """The cache's storage format, as JAX `_decode_clone` resolves it:
    None or 'fp' keep the model's own `kv_quant` (None: full precision),
    'int8' quantizes; any other value raises ValueError, and so does
    int8 with a rolling cache (no scale plane for the modular slot
    rewrite). Returns None or 'int8'."""
    if kv_quant in (None, "fp"):
        kv_quant = getattr(model, "kv_quant", None)
    if kv_quant is None:
        return None
    if kv_quant != "int8":
        raise ValueError(
            f"kv_quant must be None, 'fp' or 'int8', got {kv_quant!r}")
    if rolling:
        raise ValueError(
            "kv_quant='int8' and rolling are mutually exclusive cache "
            "layouts (no scale plane for the modular slot rewrite)")
    return "int8"


def init_cache(model, batch_size: int, max_len: int,
               paged_blocks: Optional[int] = None,
               kv_block: Optional[int] = None,
               kv_quant: Optional[str] = None,
               rolling: bool = False) -> KVCache:
    """Zero-filled cache for a [batch_size, max_len] generation budget on
    the model's device, index 0: [batch_size, max_len, KV heads, D] a
    layer; with `paged_blocks`, a `PagedKVCache` of that many
    `kv_block`-token blocks a layer (default block 16, TFDE_KV_BLOCK's
    default) and a zero [batch_size, ceil((max_len + 1) / kv_block)]
    table. `kv_quant='int8'` (`resolve_kv_quant`) makes the payloads
    int8 and adds zero fp32 scale planes ([batch_size, max_len, Kv] or
    [paged_blocks, block, Kv]; zeros dequantize to the fp cache's exact
    0.0). `rolling=True` on a model with a sliding window gives each
    windowed layer [batch_size, min(max_len, window), Kv, D] rolling
    planes (`KVCache.rolling`; an 'alternate' model's global layers keep
    the full budget); on a model without one it is the full cache, as
    JAX's `_decode_clone` engages the rolling layers only under a window.
    Rolling with `paged_blocks` or int8 raises ValueError, as in JAX."""
    if rolling and paged_blocks is not None:
        raise ValueError(
            "paged_blocks and rolling are mutually exclusive cache layouts")
    windowed = rolling and getattr(model, "sliding_window", None) is not None
    quant = resolve_kv_quant(model, kv_quant,
                             rolling if kv_quant == "int8" else windowed)
    dtype = torch.int8 if quant else model.dtype
    if paged_blocks is not None:
        block = 16 if kv_block is None else int(kv_block)
        if paged_blocks < 2 or block < 1:
            raise ValueError(f"paged_blocks must be >= 2 and kv_block >= 1, "
                             f"got {paged_blocks} and {block}")
        shapes = [(int(paged_blocks), block, model.kv_heads,
                   model.head_dim)] * model.depth
    else:
        windows = [blk.attn.window if windowed else None
                   for blk in model.decoder.blocks()]
        shapes = [(batch_size, max_len if w is None else min(max_len, w),
                   model.kv_heads, model.head_dim) for w in windows]

    def planes(plane_dtype, cell_dims=4):
        return [torch.zeros(shape[:cell_dims], dtype=plane_dtype,
                            device=model.device) for shape in shapes]

    keys, values = planes(dtype), planes(dtype)
    scales = ((planes(torch.float32, 3), planes(torch.float32, 3))
              if quant else (None, None))
    if paged_blocks is not None:
        nmax = -(-(max_len + 1) // block)
        table = torch.zeros((batch_size, nmax), dtype=torch.int64,
                            device=model.device)
        return PagedKVCache(keys, values, table, block, 0, *scales)
    return KVCache(keys, values, 0, *scales, rolling=windowed)


@contextlib.contextmanager
def remat_off(model):
    """Every `Encoder` of `model` with remat off for the duration, then as
    it was: remat only shapes the backward, which decode does not have,
    so a model trained with it serves as the same function."""
    # only encoders with remat on are written: a model served by several
    # threads at once (replicas of one process) with remat off is never
    # mutated, so the threads cannot restore each other's values
    encoders = [m for m in model.modules()
                if isinstance(m, Encoder) and m.remat is not None]
    saved = [e.remat for e in encoders]
    for e in encoders:
        e.remat = None
    try:
        yield model
    finally:
        for e, remat in zip(encoders, saved):
            e.remat = remat


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


_M32 = 0xFFFFFFFF


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A bijective 32-bit integer hash (xor-shift-multiply) of int64
    tensors holding values in [0, 2^32); both multipliers are below 2^31,
    so no product leaves int64."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x6C8E9CF5) & _M32
    return x ^ (x >> 16)


def gumbel_noise(seed, step: int, batch: int, vocab: int,
                 device=None) -> torch.Tensor:
    """[batch, vocab] float32 Gumbel(0, 1) noise, a pure function of
    (seed, step, row, token id): the row's key hashes (seed, step, row),
    each token's uniform u in (0, 1) is 24 bits of a hash of (key, token
    id), and the noise is -log(-log(u)). `seed` is an int or an integer
    tensor (0-dim): a traced program takes it as an input."""
    seed = torch.as_tensor(seed, device=device).to(torch.int64) & _M32
    key = _mix32(_mix32(seed ^ 0x9E3779B9) ^ (step & _M32))
    rows = _mix32(key ^ torch.arange(batch, device=seed.device))
    cols = torch.arange(vocab, device=seed.device)
    h = _mix32(_mix32(rows[:, None] ^ cols[None, :]))
    u = ((h >> 8).float() + 0.5) * 2.0 ** -24
    return -torch.log(-torch.log(u))


def sample_logits(logits: torch.Tensor,
                  generator: Optional[torch.Generator] = None,
                  temperature: float = 1.0, top_k: Optional[int] = None,
                  top_p: Optional[float] = None,
                  min_p: Optional[float] = None,
                  repetition_penalty: float = 1.0,
                  seen: Optional[torch.Tensor] = None,
                  noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, V] logits -> [B] int64 token ids. temperature=0 is greedy
    (argmax, first index on ties); otherwise a draw from the filtered
    distribution: with `noise` ([B, V] Gumbel noise, `gumbel_noise`) the
    Gumbel-max draw argmax(filtered logits + noise), else
    `torch.multinomial` with `generator`. `seen` [B, V] bool marks ids
    already in the row (prompt included) for the repetition penalty."""
    if temperature == 0.0:
        return torch.argmax(
            _penalize(logits.float(), repetition_penalty, seen), dim=-1)
    logits = filter_logits(logits, temperature, top_k, top_p, min_p,
                           repetition_penalty, seen)
    if noise is not None:
        return torch.argmax(logits + noise, dim=-1)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


@torch.no_grad()
def generate(model, prompt, max_new_tokens: int,
             generator: Optional[torch.Generator] = None,
             temperature: float = 0.0, top_k: Optional[int] = None,
             top_p: Optional[float] = None, min_p: Optional[float] = None,
             eos_id: Optional[int] = None, pad_id: int = 0,
             repetition_penalty: float = 1.0, device=None, seed=None):
    """Generate `max_new_tokens` continuations of `prompt` [B, P].

    Returns (tokens [B, P + max_new_tokens], lengths [B]) as int64 tensors:
    post-EOS positions hold `pad_id`; `lengths[b]` counts the prompt and
    the generated tokens through EOS. Sampling (temperature > 0) draws
    with `generator`, or, given `seed` (an int or a 0-dim integer tensor),
    by Gumbel-max over `gumbel_noise(seed, step, ...)`: what an exported
    artifact draws (export/generative.py). `prefill_token`, then
    `decode_token` once a further token, the decode ticks at a per-row
    position tensor [B] (the two functions an artifact exports). A model
    with a sliding window decodes on the rolling cache (`init_cache(...,
    rolling=True)`), as JAX's `generate` does, its ticks at the shared
    int position the rolling layers take. Runs on `device` (CUDA by
    default), which must be the model's."""
    device = resolve_device(device)
    if model.device != device:
        raise ValueError(f"model is on {model.device}, generate was asked "
                         f"for {device}")
    if generator is not None and seed is not None:
        raise ValueError("sample with a generator or a seed, not both")
    with remat_off(model):
        prompt = torch.as_tensor(np.asarray(prompt), dtype=torch.int64,
                                 device=device)
        b, p = prompt.shape
        total = validate_budget(model, p, max_new_tokens)
        cache = init_cache(model, b, total, rolling=True)
        sample = dict(generator=generator, temperature=temperature,
                      top_k=top_k, top_p=top_p, min_p=min_p,
                      repetition_penalty=repetition_penalty)
        seen = None
        if repetition_penalty != 1.0:
            seen = torch.zeros((b, model.vocab_size), dtype=torch.bool,
                               device=device)
            seen[torch.arange(b, device=device)[:, None], prompt] = True
        tok, done = prefill_token(model, prompt, cache, seed, sample, eos_id,
                                  seen)
        if not cache.rolling:
            cache.set_index(torch.full((b,), p, dtype=torch.int64,
                                       device=device))
        new = [tok]
        for step in range(1, max_new_tokens):
            tok, done = decode_token(model, tok, done, cache, step, seed,
                                     sample, eos_id, pad_id, seen)
            new.append(tok)
        return finish(prompt, torch.stack(new, dim=1), eos_id)


def _check_ragged(prompt_lengths, b: int, p_max: int, prefill_len):
    """`generate_ragged`'s argument checks, JAX's: returns (lengths
    [B] np.int64, prefill_len)."""
    lengths = np.asarray(prompt_lengths, np.int64)
    if lengths.shape != (b,):
        raise ValueError(
            f"prompt_lengths must be [batch]={b}, got {lengths.shape}")
    if lengths.min() < 1 or lengths.max() > p_max:
        raise ValueError(
            f"prompt_lengths must lie in [1, {p_max}], got "
            f"[{lengths.min()}, {lengths.max()}]")
    if prefill_len is None:
        prefill_len = int(lengths.min())
    if not 1 <= prefill_len <= lengths.min():
        raise ValueError(
            f"prefill_len={prefill_len} must lie in [1, min(prompt_lengths)="
            f"{lengths.min()}] — prefilling past a row's prompt would feed "
            f"its padding into the cache")
    return lengths, int(prefill_len)


@torch.no_grad()
def generate_ragged(model, prompt, prompt_lengths, max_new_tokens: int,
                    generator: Optional[torch.Generator] = None,
                    prefill_len: Optional[int] = None,
                    temperature: float = 0.0, top_k: Optional[int] = None,
                    top_p: Optional[float] = None,
                    min_p: Optional[float] = None,
                    eos_id: Optional[int] = None, pad_id: int = 0,
                    device=None):
    """`generate` for a batch of prompts of DIFFERENT lengths.

    `prompt` is [B, Pmax] right-padded, `prompt_lengths` [B] each row's
    real length. Returns (tokens [B, Pmax + max_new_tokens], lengths [B])
    as int64 tensors, row r's continuation from slot `prompt_lengths[r]`,
    pad after its end. The first `prefill_len` slots (default the
    shortest prompt) prefill at index 0 (the flash kernel on a CUDA
    tensor); then every further slot is one decode step whose input is
    the row's own prompt token while the row is inside its prompt and its
    sampled continuation after, so the cache never holds padding and
    greedy rows equal solo `generate` runs. A model with a sliding window
    decodes on the rolling cache, as in JAX. Sampling draws from
    `generator` once a slot for every row (JAX splits its key once a
    slot)."""
    device = resolve_device(device)
    if model.device != device:
        raise ValueError(f"model is on {model.device}, generate_ragged was "
                         f"asked for {device}")
    prompt = torch.as_tensor(np.asarray(prompt), dtype=torch.int64,
                             device=device)
    b, p_max = prompt.shape
    lengths_np, prefill_len = _check_ragged(prompt_lengths, b, p_max,
                                            prefill_len)
    sample = dict(temperature=temperature, top_k=top_k, top_p=top_p,
                  min_p=min_p)
    with remat_off(model):
        total = validate_budget(model, p_max, max_new_tokens)
        cache = init_cache(model, b, total, rolling=True)
        lengths = torch.as_tensor(lengths_np, device=device)
        slots = torch.arange(p_max, device=device)
        seq = torch.cat([
            torch.where(slots[None] < lengths[:, None], prompt, pad_id),
            torch.full((b, max_new_tokens), pad_id, dtype=torch.int64,
                       device=device)], dim=1)
        logits = model.head(
            model.hidden(prompt[:, :prefill_len], cache=cache)[:, -1])
        gen_count = torch.zeros(b, dtype=torch.int64, device=device)
        done = torch.zeros(b, dtype=torch.bool, device=device)
        for t in range(prefill_len, total):
            sampled = sample_logits(logits, generator, **sample)
            in_prompt = t < lengths
            can_gen = ~in_prompt & ~done & (gen_count < max_new_tokens)
            tok = torch.where(in_prompt, seq[:, t],
                              torch.where(can_gen, sampled, pad_id))
            gen_count = gen_count + can_gen.long()
            if eos_id is not None:
                done = done | (can_gen & (sampled == eos_id))
            seq[:, t] = tok
            if t < total - 1:  # the last slot's logits would feed nothing
                logits = model(tok[:, None], cache=cache)[:, -1]
        return seq, lengths + gen_count


def _noise(model, seed, step, b, sample):
    if seed is None or sample["temperature"] == 0.0:
        return None
    return gumbel_noise(seed, step, b, model.vocab_size, model.device)


def prefill_token(model, prompt, cache, seed, sample: dict, eos_id,
                  seen=None):
    """The prompt through the model into `cache` (index 0: the flash
    prefill), the head on the last position only (a prompt's other logits,
    [B, P, V] in fp32, are never read), then the first token: (token [B],
    done [B] — which rows drew `eos_id`)."""
    b = prompt.shape[0]
    logits = model.head(model.hidden(prompt, cache=cache)[:, -1])
    tok = sample_logits(logits, seen=seen,
                        noise=_noise(model, seed, 0, b, sample), **sample)
    if seen is not None:
        seen[torch.arange(b, device=tok.device), tok] = True
    done = (tok == eos_id) if eos_id is not None else torch.zeros(
        b, dtype=torch.bool, device=tok.device)
    return tok, done


def decode_token(model, tok, done, cache, step, seed, sample: dict, eos_id,
                 pad_id: int, seen=None):
    """One decode tick: `tok` [B] at the cache's positions, then token
    number `step` (an int or a 0-dim tensor; it keys `gumbel_noise`);
    rows already done emit `pad_id`. Returns (token [B], done [B])."""
    b = tok.shape[0]
    logits = model(tok[:, None], cache=cache)[:, -1]
    nxt = sample_logits(logits, seen=seen,
                        noise=_noise(model, seed, step, b, sample), **sample)
    if eos_id is not None:
        nxt = torch.where(done, torch.full_like(nxt, pad_id), nxt)
        done = done | (nxt == eos_id)
    if seen is not None:
        seen[torch.arange(b, device=nxt.device), nxt] = True
    return nxt, done


def finish(prompt, new_tokens, eos_id):
    """(tokens [B, P + N], lengths [B]): the prompt and the new tokens,
    and how many of them count — the prompt and the generated tokens
    through EOS."""
    b, p = prompt.shape
    tokens = torch.cat([prompt, new_tokens], dim=1)
    if eos_id is None:
        lengths = torch.full((b,), tokens.shape[1], dtype=torch.int64,
                             device=prompt.device)
    else:
        # a position counts while no EOS appeared strictly before it
        is_eos = (new_tokens == eos_id).long()
        seen_before = torch.cumsum(is_eos, dim=1) - is_eos
        lengths = p + (seen_before == 0).long().sum(dim=1)
    return tokens, lengths
