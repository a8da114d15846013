"""Speculative decoding — counterpart of `tfde_tpu/inference/speculative.py`.

A small DRAFT model proposes `num_draft` tokens through its own KV cache,
one single-token step at a time; the TARGET model scores all of them in
ONE forward of `num_draft + 1` tokens. Two modes share the round:

- temperature == 0 (default): the draft proposes greedily; the longest
  prefix where the target's greedy choice agrees is committed, plus the
  target's own choice at the first disagreement (the bonus token on full
  acceptance). Each row equals greedy `generate` token for token. As in
  JAX, the verify forward scores num_draft + 1 positions in one GEMM where
  `generate` scores one at a time, so a bf16 near-tie of the top two
  logits can resolve otherwise; fp32 holds the tokens exactly.
- temperature > 0: speculative SAMPLING (Leviathan et al.): the draft
  samples, the target accepts proposal d with probability min(1,
  p_t(d) / p_d(d)) and at the first rejection samples the residual
  norm(max(0, p_t - p_d)); on full acceptance the bonus token samples
  p_t. The committed tokens are distributed as target sampling at that
  temperature; draft quality moves only the speed. Draws come from an
  explicit `torch.Generator` (JAX's key).

Rewind is index surgery (`KVCache.set_index`, JAX's `_set_index_counters`):
rejected proposals leave stale K/V past each row's committed count, which
no mask reaches and the next round overwrites. Batch 1 rewinds to an int
(the shared-index branch of the decode attention), batch > 1 to a [B]
tensor (the per-row branch: acceptance lengths diverge). Both caches are
sized `prompt + max_new_tokens + num_draft + 1`, so a round's writes never
reach the clamp of the cache write. Both caches are full-budget: a rewind
would alias the rolling cache's slots.

Invariant between rounds: both caches hold K/V for exactly row r's
committed text (`committed[r]` tokens) and `tok[r]` is the last committed
token, generated but not yet fed. One host fetch a round brings back the
round's tokens and counts. The prefills run at index 0 (the flash kernel
on a CUDA tensor); the draft steps and the verify forward take the masked
einsum over the cache, as JAX's decode attention does. PyTorch runs
eagerly: the draft loop is a host loop of single-token steps.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from tfde_tpu_torch.inference.decode import (
    init_cache, remat_off, sample_logits, validate_budget)
from tfde_tpu_torch.utils.devices import resolve_device


def _assemble_round(props, n_acc, pending, num_draft: int, pad_id: int):
    """round_tokens [B, num_draft + 1]: row r's accepted proposals, then
    its pending token at position n_acc[r], pad after; props [B,
    num_draft], n_acc and pending [B]."""
    b = props.shape[0]
    ar = torch.arange(num_draft + 1, device=props.device)[None, :]
    ext = torch.cat([props, props.new_full((b, 1), pad_id)], dim=1)
    out = torch.where(ar < n_acc[:, None], ext, pad_id)
    return torch.where(ar == n_acc[:, None], pending[:, None], out)


def _first_false(ok: torch.Tensor, num_draft: int) -> torch.Tensor:
    """[B] the length of each row's True-prefix of ok [B, num_draft]."""
    return torch.where(ok.all(dim=1), num_draft,
                       (~ok).long().argmax(dim=1))


def _prefill(tgt, drf, tgt_cache, drf_cache, prompt):
    """The whole prompt into both caches (the round feeds the last token
    next, so each needs K/V for everything before it); the target's
    logits at the last position, [B, V] fp32. The draft's head never
    runs: only its K/V are needed."""
    logits = tgt.head(tgt.hidden(prompt, cache=tgt_cache)[:, -1])
    drf.hidden(prompt, cache=drf_cache)
    return logits


def _draft_and_verify(tgt, drf, tgt_cache, drf_cache, tok_last, num_draft,
                      propose):
    """The round's shared skeleton: `num_draft` single-token draft steps
    (`propose(logits [B, V], i)` -> token [B]), the last proposal fed too
    (on full acceptance its K/V must be in the draft cache), then ONE
    target forward over [tok_last, proposals]. Returns (proposals [B,
    num_draft], target logits [B, num_draft + 1, V] fp32)."""
    tok, props = tok_last, []
    for i in range(num_draft):
        tok = propose(drf(tok[:, None], cache=drf_cache)[:, -1], i)
        props.append(tok)
    drf.hidden(tok[:, None], cache=drf_cache)
    props = torch.stack(props, dim=1)
    verify_in = torch.cat([tok_last[:, None], props], dim=1)
    return props, tgt(verify_in, cache=tgt_cache)


def _spec_round(tgt, drf, tgt_cache, drf_cache, tok_last, num_draft: int,
                pad_id: int):
    """One greedy round -> (round_tokens [B, num_draft + 1] pad-filled,
    n_new [B], pending [B]). round_tokens[r, :n_new[r]] are row r's
    accepted proposals and the target's token at its first disagreement
    (the bonus token on full acceptance)."""
    props, logits = _draft_and_verify(
        tgt, drf, tgt_cache, drf_cache, tok_last, num_draft,
        lambda lg, _i: torch.argmax(lg, dim=-1))
    targets = torch.argmax(logits, dim=-1)  # [B, num_draft + 1]
    # targets[r, i]: the target's choice after verify_in[r, :i + 1]
    n_acc = _first_false(targets[:, :num_draft] == props, num_draft)
    pending = torch.gather(targets, 1, n_acc[:, None])[:, 0]
    return (_assemble_round(props, n_acc, pending, num_draft, pad_id),
            n_acc + 1, pending)


def _spec_round_sampled(tgt, drf, tgt_cache, drf_cache, tok_last,
                        generator, num_draft: int, pad_id: int,
                        temperature: float):
    """One speculative SAMPLING round (Leviathan et al.), same outputs as
    `_spec_round`: the draft samples d_i ~ p_d; d_i is accepted with
    probability min(1, p_t(d_i) / p_d(d_i)); at the first rejection the
    replacement samples norm(max(0, p_t - p_d)) (p_t where that is zero
    everywhere), on full acceptance the bonus samples p_t. Every draw
    comes from `generator`; rows draw independently."""
    inv_t = 1.0 / temperature
    drf_logps = []

    def propose(logits, _i):
        logp = torch.log_softmax(logits * inv_t, dim=-1)
        drf_logps.append(logp)
        return torch.multinomial(logp.exp(), 1, generator=generator)[:, 0]

    props, logits = _draft_and_verify(tgt, drf, tgt_cache, drf_cache,
                                      tok_last, num_draft, propose)
    drf_logps = torch.stack(drf_logps, dim=1)  # [B, num_draft, V]
    tgt_logps = torch.log_softmax(logits * inv_t, dim=-1)  # [B, nd + 1, V]
    b = props.shape[0]
    u = torch.rand((b, num_draft), generator=generator, device=props.device)
    at = props[..., None]
    ratio = torch.exp(torch.gather(tgt_logps[:, :num_draft], 2, at)
                      - torch.gather(drf_logps, 2, at))[..., 0]
    n_acc = _first_false(u < torch.clamp(ratio, max=1.0), num_draft)
    rows = torch.arange(b, device=props.device)
    p_t = tgt_logps[rows, n_acc].exp()  # [B, V]
    p_d = drf_logps[rows, torch.clamp(n_acc, max=num_draft - 1)].exp()
    resid = torch.clamp(p_t - p_d, min=0.0)
    total = resid.sum(dim=-1, keepdim=True)
    resid = torch.where(total > 0, resid / torch.clamp(total, min=1e-30), p_t)
    replacement = torch.multinomial(resid, 1, generator=generator)[:, 0]
    bonus = torch.multinomial(tgt_logps[:, num_draft].exp(), 1,
                              generator=generator)[:, 0]
    pending = torch.where(n_acc == num_draft, bonus, replacement)
    return (_assemble_round(props, n_acc, pending, num_draft, pad_id),
            n_acc + 1, pending)


def run_round(tgt, drf, tgt_cache, drf_cache, tok_last, num_draft: int,
              pad_id: int, temperature: float = 0.0,
              generator: Optional[torch.Generator] = None):
    """One round, greedy or sampled by `temperature`: (round_tokens,
    n_new, pending) as `_spec_round` returns them."""
    if temperature > 0.0:
        return _spec_round_sampled(tgt, drf, tgt_cache, drf_cache, tok_last,
                                   generator, num_draft, pad_id, temperature)
    return _spec_round(tgt, drf, tgt_cache, drf_cache, tok_last, num_draft,
                       pad_id)


def fetch_round(round_tokens, n_new):
    """THE host sync of a round: (round_tokens [B, nd + 1], n_new [B]) as
    numpy in one device->host copy."""
    both = torch.cat([round_tokens, n_new[:, None]], dim=1).cpu().numpy()
    return both[:, :-1], both[:, -1]


@torch.no_grad()
def generate_speculative(model, draft_model, prompt, max_new_tokens: int,
                         num_draft: int = 4, temperature: float = 0.0,
                         generator: Optional[torch.Generator] = None,
                         eos_id: Optional[int] = None, pad_id: int = 0,
                         return_stats: bool = False, device=None):
    """Generation of the TARGET `model`, accelerated by `draft_model` (a
    model of the same vocabulary on the same device).

    prompt is [B, P] (rows share a prompt length, as for `generate`).
    Greedy (temperature 0) rows equal greedy `generate(model, prompt,
    ...)`; at temperature > 0 the rounds run speculative sampling, drawing
    from `generator`. Returns (tokens [B, P + max_new_tokens], lengths
    [B]) as int64 tensors, post-EOS positions `pad_id`; with
    `return_stats` also {"rounds", "generated", "tokens_per_round",
    "acceptance_rate"}: tokens a round a row beyond the prefill's first
    token (0.0 without a round), as JAX reports them, and the share of
    the draft's proposals committed (the port's addition), counting only
    the proposals the row's remaining budget could commit (the batcher's
    `stats()` counts num_draft a row a round, as JAX's). Rounds run until
    every row is done; finished rows ride along at frozen indices. Runs
    on `device` (CUDA by default), which must be both models'."""
    device = resolve_device(device)
    for m in (model, draft_model):
        if m.device != device:
            raise ValueError(f"model is on {m.device}, "
                             f"generate_speculative was asked for {device}")
    prompt = torch.as_tensor(np.asarray(prompt), dtype=torch.int64,
                             device=device)
    b, p = prompt.shape
    if num_draft < 1:
        raise ValueError(f"num_draft must be >= 1, got {num_draft}")
    total = validate_budget(model, p, max_new_tokens)
    validate_budget(draft_model, p, max_new_tokens)
    # each round feeds num_draft + 1 tokens past the committed count
    cache_len = total + num_draft + 1
    with remat_off(model), remat_off(draft_model):
        tgt_cache = init_cache(model, b, cache_len)
        drf_cache = init_cache(draft_model, b, cache_len)
        first = _prefill(model, draft_model, tgt_cache, drf_cache, prompt)
        tok = sample_logits(first, generator, temperature=temperature)
        tok_np = tok.cpu().numpy()
        out_tokens = [[int(t)] for t in tok_np]  # per-row committed stream
        committed = np.full(b, p, np.int64)
        done = np.zeros(b, bool)
        if eos_id is not None:
            done |= tok_np == eos_id
        rounds = proposed = accepted = 0

        def active(r):
            return not done[r] and len(out_tokens[r]) < max_new_tokens

        while any(active(r) for r in range(b)):
            rounds += 1
            for cache in (tgt_cache, drf_cache):
                cache.set_index(int(committed[0]) if b == 1 else
                                torch.as_tensor(committed, device=device))
            round_toks, n_new, _ = run_round(
                model, draft_model, tgt_cache, drf_cache, tok, num_draft,
                pad_id, temperature, generator)
            round_np, n_np = fetch_round(round_toks, n_new)
            for r in range(b):
                if not active(r):
                    continue
                # the proposals the budget lets the round commit: one of
                # the row's remaining tokens is the target's own
                room = max_new_tokens - len(out_tokens[r])
                proposed += min(num_draft, room - 1)
                toks = round_np[r, :int(n_np[r])].tolist()
                if eos_id is not None and eos_id in toks:
                    toks = toks[:toks.index(eos_id) + 1]
                    done[r] = True
                toks = toks[:max_new_tokens - len(out_tokens[r])]
                committed[r] += len(toks)  # tok_last + the accepted ones
                out_tokens[r].extend(toks)
                accepted += min(max(len(toks) - 1, 0), num_draft)
            tok = torch.as_tensor([row[-1] for row in out_tokens],
                                  dtype=torch.int64, device=device)
    new = np.full((b, max_new_tokens), pad_id, np.int64)
    for r in range(b):
        new[r, :len(out_tokens[r])] = out_tokens[r]
    tokens = torch.cat([prompt, torch.as_tensor(new, device=device)], dim=1)
    lengths = torch.as_tensor([p + len(row) for row in out_tokens],
                              dtype=torch.int64, device=device)
    if not return_stats:
        return tokens, lengths
    generated = sum(len(row) for row in out_tokens)
    return tokens, lengths, {
        "rounds": rounds,
        "generated": generated,
        "tokens_per_round": ((generated - b) / (rounds * b) if rounds
                             else 0.0),
        "acceptance_rate": accepted / max(proposed, 1),
    }
