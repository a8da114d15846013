"""Generative serving export — counterpart of `tfde_tpu/export/generative.py`
(`export_generate` :46, `GenerativeModel` :114, `load_generate` :128).

Where export/serving.py freezes a single forward pass, a token model's
servable unit is the generation program: prefill, the KV-cache decode
loop and sampling (`inference.decode.generate`), loadable and callable
with no model code, deterministic given (prompt, seed). The artifact keeps
the JAX package's layout and signature keys:

    <dir>/<timestamp>/
      signature.json   kind "generate", prompt/seed/outputs spec, the
                       burned-in sampling config, the two programs
      params.npz       the model's parameters and buffers
      model.pt2        `torch.export` of the prefill: (prompt, seed) ->
                       the first token, the rows done, the KV cache
      step.pt2         `torch.export` of one decode tick: (token, done,
                       positions, step, seed, KV cache) -> the next token
                       and the rows done, the cache written in place

The entry point, `GenerativeModel.generate`, is `(prompt [B, P] int32,
seed []) -> (tokens [B, P + N] int32, lengths [B] int32)` with B, P and
N fixed at export: the prefill, then N - 1 ticks, as `generate` runs
them (`decode.prefill_token`, `decode.decode_token`). The JAX package
exports the whole loop as one XLA program (a scan); `torch.export`
unrolls a Python loop instead, so one program of N ticks is N times a
tick's graph (GPT-2 small at N = 32: ~40k nodes, minutes to trace, to
save and to load), and the artifact holds the tick once.

The sampling configuration (temperature, top_k, top_p, min_p, eos_id,
pad_id) is part of the traced programs; the seed stays a runtime input,
so one artifact serves any number of sampled continuations. A
`torch.Generator` cannot be an input of a traced program, so the
programs draw by Gumbel-max over `decode.gumbel_noise`, a pure function
of (seed, step, row, token id): `generate(model, prompt, n, seed=s,
...)` in process gives the same tokens as the artifact for the same seed.

The programs are traced on the model's own device with fake tensors: on
CUDA the prefill's attention records the flash kernels' op
(`tfde::flash_forward`), which the loaded artifact launches on the card.
`validate_budget` checks P + N against the model before tracing, as the
JAX export does.
"""

from __future__ import annotations

import copy
import json
import logging
import os
from typing import Optional

import numpy as np
import torch
from torch import nn

from tfde_tpu_torch.export.serving import (
    _host_vars, _load_program, _resolve, _write_artifact)
from tfde_tpu_torch.inference.decode import (
    KVCache, decode_token, finish, init_cache, prefill_token, remat_off,
    resolve_kv_quant, validate_budget)
from tfde_tpu_torch.utils.devices import resolve_device

log = logging.getLogger(__name__)

STEP_FILE = "step.pt2"


def _sample(sampling: dict) -> dict:
    """`sample_logits`'s options from an artifact's sampling config."""
    return dict(temperature=sampling["temperature"], top_k=sampling["top_k"],
                top_p=sampling["top_p"], min_p=sampling["min_p"])


class _Prefill(nn.Module):
    """(prompt [B, P] int32, seed) -> (token [B], done [B], keys...,
    values...): a fresh cache of P + N positions, the prompt through it,
    the first token."""

    def __init__(self, model: nn.Module, max_new_tokens: int, sampling):
        super().__init__()
        self.model = model
        self.max_new_tokens = max_new_tokens
        self.sampling = sampling

    def forward(self, prompt: torch.Tensor, seed: torch.Tensor):
        b, p = prompt.shape
        cache = init_cache(self.model, b, p + self.max_new_tokens)
        tok, done = prefill_token(self.model, prompt.long(), cache, seed,
                                  _sample(self.sampling),
                                  self.sampling["eos_id"])
        return (tok, done, *cache.keys, *cache.values)


class _Step(nn.Module):
    """(token [B], done [B], positions [B], step [], seed, keys...,
    values...) -> (token [B], done [B]): one decode tick, the cache
    written in place at the positions."""

    def __init__(self, model: nn.Module, sampling):
        super().__init__()
        self.model = model
        self.sampling = sampling

    def forward(self, tok, done, pos, step, seed, *kv):
        depth = len(kv) // 2
        cache = KVCache(list(kv[:depth]), list(kv[depth:]), pos)
        return decode_token(self.model, tok, done, cache, step, seed,
                            _sample(self.sampling), self.sampling["eos_id"],
                            self.sampling["pad_id"])


def export_generate(model: nn.Module, directory: str, prompt_len: int,
                    max_new_tokens: int, batch_size: int = 1,
                    temperature: float = 0.0, top_k: Optional[int] = None,
                    top_p: Optional[float] = None,
                    min_p: Optional[float] = None,
                    eos_id: Optional[int] = None, pad_id: int = 0) -> str:
    """Write a generative serving artifact of `model` (a `models.gpt.GPT`)
    into a new timestamped directory under `directory`; returns it.

    `load_generate(dir).generate(prompt, seed)` maps (prompt [B, P] int32,
    seed) -> (tokens [B, P + N] int32, lengths [B] int32) with B =
    batch_size, P = prompt_len and N = max_new_tokens fixed (export one
    artifact per serving bucket)."""
    validate_budget(model, prompt_len, max_new_tokens)
    if resolve_kv_quant(model) is not None:
        raise NotImplementedError(
            "export_generate of a model with kv_quant='int8': the exported "
            "tick carries no scale planes (ROADMAP queue 1 item 3.4)")
    sampling = dict(temperature=temperature, top_k=top_k, top_p=top_p,
                    min_p=min_p, eos_id=eos_id, pad_id=pad_id)
    traced = copy.deepcopy(model).eval()
    device = traced.device
    total = prompt_len + max_new_tokens
    seed = torch.zeros((), dtype=torch.int64, device=device)
    prompt = torch.zeros((batch_size, prompt_len), dtype=torch.int32,
                         device=device)
    cache = init_cache(traced, batch_size, total)
    tick = (torch.zeros(batch_size, dtype=torch.int64, device=device),
            torch.zeros(batch_size, dtype=torch.bool, device=device),
            torch.full((batch_size,), prompt_len, dtype=torch.int64,
                       device=device),
            torch.ones((), dtype=torch.int64, device=device), seed,
            *cache.keys, *cache.values)
    with torch.no_grad(), remat_off(traced):
        prefill = torch.export.export(
            _Prefill(traced, max_new_tokens, sampling), (prompt, seed),
            strict=False)
        step = torch.export.export(_Step(traced, sampling), tick,
                                   strict=False)
    out_dir = _write_artifact(directory, prefill, _host_vars(traced), {
        "kind": "generate",
        "inputs": {
            "prompt": {"shape": [batch_size, prompt_len], "dtype": "int32"},
            "seed": {"shape": [], "dtype": "int64"},
        },
        # the entry point returns a (tokens, lengths) TUPLE
        "outputs": {
            "tokens": {"shape": [batch_size, total], "dtype": "int32"},
            "lengths": {"shape": [batch_size], "dtype": "int32"},
        },
        "max_new_tokens": max_new_tokens,
        "sampling": sampling,
        "programs": {"prefill": "model.pt2", "step": STEP_FILE},
        "platforms": ["cpu", "cuda"],
        "framework": "tfde_tpu_torch",
    })
    torch.export.save(step, os.path.join(out_dir, STEP_FILE))
    log.info("generative artifact exported -> %s", out_dir)
    return out_dir


class GenerativeModel:
    """A loaded generative artifact on `device`: `generate(prompt, seed)`
    -> (tokens, lengths) as numpy arrays, the prefill program then the
    tick program N - 1 times."""

    def __init__(self, prefill, step, signature: dict, params: dict,
                 device: torch.device):
        self.prefill = prefill.module()
        self.step = step.module()
        self.signature = signature
        self.params = params
        self.device = device

    def generate(self, prompt, seed: int = 0):
        prompt = torch.as_tensor(np.asarray(prompt), dtype=torch.int32,
                                 device=self.device)
        seed = torch.tensor(int(seed), dtype=torch.int64, device=self.device)
        b, p = prompt.shape
        with torch.no_grad():
            tok, done, *kv = self.prefill(prompt, seed)
            pos = torch.full((b,), p, dtype=torch.int64, device=self.device)
            new = [tok]
            for step in range(1, self.signature["max_new_tokens"]):
                tok, done = self.step(
                    tok, done, pos, torch.tensor(step, device=self.device),
                    seed, *kv)
                pos = pos + 1
                new.append(tok)
            tokens, lengths = finish(prompt.long(), torch.stack(new, dim=1),
                                     self.signature["sampling"]["eos_id"])
        return tokens.int().cpu().numpy(), lengths.int().cpu().numpy()


def load_generate(export_dir: str, device=None) -> GenerativeModel:
    """Load a generative artifact from its timestamped directory, or from
    the parent, resolving the newest timestamp. It runs on `device`: CUDA
    by default, the CPU when asked (`resolve_device`)."""
    device = resolve_device(device)
    path = _resolve(export_dir)
    with open(os.path.join(path, "signature.json")) as f:
        signature = json.load(f)
    if signature.get("kind") != "generate":
        raise ValueError(
            f"{export_dir} is not a generative artifact "
            f"(kind={signature.get('kind')!r}); use export.serving."
            f"load_serving for forward-pass artifacts")
    prefill, params = _load_program(path, device)
    from torch.export.passes import move_to_device_pass

    step = move_to_device_pass(
        torch.export.load(os.path.join(path, STEP_FILE)), device)
    return GenerativeModel(prefill, step, signature, params, device)
