"""Pretrained-checkpoint conversion — counterpart of
`tfde_tpu/models/convert.py`, for the dense GPT-class families.

A transformers checkpoint (a local `save_pretrained()` directory) becomes
the port's `models/gpt.GPT`, and an artifact that the JAX package reads
too:

    <out>/params.npz          the flax-layout params, flat '/'-joined keys
    <out>/model_config.json   the JAX `GPT` fields, "family", "dtype"

Each `*_from_hf` builds the flax-layout numpy tree exactly as the JAX
converter does (pure reshaping on the host: fused projections split,
per-head interleaves undone, Gemma's zero-centred norm weights folded to
1 + w, OPT's offset-2 position rows dropped, Phi's partial rotary as
`rope_dim`, BigCode's and Falcon's multi-query K/V as one KV head), keeps
every refusal of the JAX converter with its wording, and returns
`(GPT, state_dict)`: the model with `models.flax_weights.from_flax_params`
of the tree loaded. `save_converted` writes the artifact from a model
(`flax_weights.to_flax_params`), `load_converted` rebuilds the model from
one written by either package, and

    python -m tfde_tpu_torch.models.convert FAMILY HF_DIR OUT

converts a local checkpoint; it never downloads. `transformers` is
imported only there: the converters read the model object they are
given.

Families: gpt2, llama, mistral, gemma, gemma2, qwen2, qwen3, phi, phi3,
neox, bigcode, opt, falcon, and the MoE families mixtral and qwen2-moe
(`models/moe.py`; both pin the dropless capacity E / k, as JAX does).
The JAX package's other families (bert, bert-classifier, t5) and its
reverse direction (`*_to_hf`, `--reverse`, the MoE families' included)
are not ported yet (ROADMAP.md, queue 1 item 2). Known approximation, as in
JAX: the Mlp's gelu is the tanh approximation, which is GPT-2's
`gelu_new` exactly and differs from the erf gelu of NeoX and Falcon by
~1e-3 in activations.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import numpy as np
import torch

from tfde_tpu_torch.export.serving import _unflatten, write_params_npz
from tfde_tpu_torch.models.flax_weights import (
    from_flax_params, to_flax_params)
from tfde_tpu_torch.models.gpt import _UNPORTED, GPT

#: CLI family -> (transformers class, converter name)
_FAMILIES = {
    "gpt2": ("GPT2LMHeadModel", "gpt2_from_hf"),
    "llama": ("LlamaForCausalLM", "llama_from_hf"),
    "mistral": ("MistralForCausalLM", "mistral_from_hf"),
    "gemma": ("GemmaForCausalLM", "gemma_from_hf"),
    "qwen2": ("Qwen2ForCausalLM", "qwen2_from_hf"),
    "phi": ("PhiForCausalLM", "phi_from_hf"),
    "neox": ("GPTNeoXForCausalLM", "neox_from_hf"),
    "bigcode": ("GPTBigCodeForCausalLM", "bigcode_from_hf"),
    "opt": ("OPTForCausalLM", "opt_from_hf"),
    "falcon": ("FalconForCausalLM", "falcon_from_hf"),
    "qwen3": ("Qwen3ForCausalLM", "qwen3_from_hf"),
    "phi3": ("Phi3ForCausalLM", "phi3_from_hf"),
    "gemma2": ("Gemma2ForCausalLM", "gemma2_from_hf"),
    "mixtral": ("MixtralForCausalLM", "mixtral_from_hf"),
    "qwen2-moe": ("Qwen2MoeForCausalLM", "qwen2moe_from_hf"),
}

#: the JAX package's families the port does not convert yet
_UNPORTED_FAMILIES = ("bert", "bert-classifier", "t5")

#: the `dtype` names an artifact records (numpy's names)
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "float64": torch.float64}


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float32)


def _build(kwargs: dict, params: dict, dtype, device
           ) -> Tuple[GPT, dict]:
    """(GPT, state_dict): the model from the JAX constructor fields
    `kwargs` in `dtype` (bf16 by default, the family's serving dtype) on
    `device`, with the flax-layout `params` loaded."""
    model = GPT(**kwargs, dtype=torch.bfloat16 if dtype is None else dtype,
                device=device)
    state = from_flax_params(params)
    model.load_state_dict(state)
    return model, state


def _sd(hf_model) -> dict:
    return {k: _np(v) for k, v in hf_model.state_dict().items()}


def _prefix(sd, pre: str) -> str:
    return pre if any(k.startswith(pre) for k in sd) else ""


def _rope_scaling_tuple(rs, max_position=None) -> "Optional[tuple]":
    """HF rope_scaling dict -> the hashable tuple ops/rotary understands:
    ('linear', factor), ('llama3', factor, low, high, orig_max), or
    ('yarn', factor, beta_fast, beta_slow, orig_max, attention_factor,
    truncate). None passes through; dynamic-NTK / longrope are refused
    (their frequency rules are not implemented — converting would produce
    silently wrong logits). `max_position` is the config's
    max_position_embeddings — yarn's original_max falls back to it, the
    HF convention."""
    import math

    if not rs:
        return None
    kind = rs.get("rope_type") or rs.get("type")
    if kind == "linear":
        return ("linear", float(rs["factor"]))
    if kind == "llama3":
        return (
            "llama3", float(rs["factor"]),
            float(rs["low_freq_factor"]), float(rs["high_freq_factor"]),
            float(rs["original_max_position_embeddings"]),
        )
    if kind == "yarn":
        factor = float(rs["factor"])
        att = rs.get("attention_factor")
        if att is None:
            # the paper's mscale rule (HF _compute_yarn_parameters)
            def get_mscale(scale, m=1.0):
                return 1.0 if scale <= 1 else 0.1 * m * math.log(scale) + 1.0

            mscale = rs.get("mscale")
            mscale_all = rs.get("mscale_all_dim")
            if mscale and mscale_all:
                att = get_mscale(factor, mscale) / get_mscale(factor,
                                                              mscale_all)
            else:
                att = get_mscale(factor)
        orig_max = (rs.get("original_max_position_embeddings")
                    or max_position)
        if orig_max is None:
            raise NotImplementedError(
                "yarn rope_scaling without original_max_position_"
                "embeddings needs the config's max_position_embeddings"
            )
        return (
            "yarn", factor,
            float(rs.get("beta_fast") or 32.0),
            float(rs.get("beta_slow") or 1.0),
            float(orig_max), float(att),
            bool(rs.get("truncate", True)),
        )
    if kind == "default":
        return None
    raise NotImplementedError(
        f"rope_scaling type {kind!r} is not supported (only 'linear', "
        f"'llama3' and 'yarn'); converting would produce silently wrong "
        f"logits"
    )


def _rope_scaling_dict(scaling) -> "Optional[dict]":
    """The inverse of _rope_scaling_tuple, for to_hf exports."""
    if scaling is None:
        return None
    scaling = tuple(scaling)
    if scaling[0] == "linear":
        return {"rope_type": "linear", "factor": float(scaling[1])}
    if scaling[0] == "llama3":
        return {
            "rope_type": "llama3", "factor": float(scaling[1]),
            "low_freq_factor": float(scaling[2]),
            "high_freq_factor": float(scaling[3]),
            "original_max_position_embeddings": int(scaling[4]),
        }
    if scaling[0] == "yarn":
        return {
            "rope_type": "yarn", "factor": float(scaling[1]),
            "beta_fast": float(scaling[2]),
            "beta_slow": float(scaling[3]),
            "original_max_position_embeddings": int(scaling[4]),
            # explicit attention_factor: guarantees the exported model
            # computes the identical temperature even if the import
            # derived it from mscale
            "attention_factor": float(scaling[5]),
            "truncate": bool(scaling[6]),
        }
    raise NotImplementedError(f"unknown rope scaling {scaling!r}")


def _gpt2(hf_model):
    cfg = hf_model.config
    heads = cfg.n_head
    hidden = cfg.n_embd
    hd = hidden // heads
    mlp_dim = cfg.n_inner if cfg.n_inner is not None else 4 * hidden
    kwargs = dict(
        vocab_size=cfg.vocab_size, hidden_size=hidden, depth=cfg.n_layer,
        num_heads=heads, mlp_dim=mlp_dim, max_position=cfg.n_positions,
        ln_eps=cfg.layer_norm_epsilon)
    sd = _sd(hf_model)
    pre = _prefix(sd, "transformer.")
    params = {
        "wte": {"embedding": sd[f"{pre}wte.weight"]},
        "wpe": {"embedding": sd[f"{pre}wpe.weight"]},
        "decoder": {
            "ln_final": {"scale": sd[f"{pre}ln_f.weight"],
                         "bias": sd[f"{pre}ln_f.bias"]},
        },
    }
    for i in range(cfg.n_layer):
        h = f"{pre}h.{i}."
        # Conv1D weight layout is [in, out] already
        c_attn_w = sd[h + "attn.c_attn.weight"]  # [H, 3H]
        c_attn_b = sd[h + "attn.c_attn.bias"]    # [3H]
        qw, kw, vw = np.split(c_attn_w, 3, axis=1)
        qb, kb, vb = np.split(c_attn_b, 3)
        params["decoder"][f"block_{i}"] = {
            "ln_attn": {"scale": sd[h + "ln_1.weight"],
                        "bias": sd[h + "ln_1.bias"]},
            "ln_mlp": {"scale": sd[h + "ln_2.weight"],
                       "bias": sd[h + "ln_2.bias"]},
            "attn": {
                "query": {"kernel": qw.reshape(hidden, heads, hd),
                          "bias": qb.reshape(heads, hd)},
                "key": {"kernel": kw.reshape(hidden, heads, hd),
                        "bias": kb.reshape(heads, hd)},
                "value": {"kernel": vw.reshape(hidden, heads, hd),
                          "bias": vb.reshape(heads, hd)},
                "out": {"kernel": sd[h + "attn.c_proj.weight"].reshape(
                            heads, hd, hidden),
                        "bias": sd[h + "attn.c_proj.bias"]},
            },
            "mlp": {
                "fc1": {"kernel": sd[h + "mlp.c_fc.weight"],
                        "bias": sd[h + "mlp.c_fc.bias"]},
                "fc2": {"kernel": sd[h + "mlp.c_proj.weight"],
                        "bias": sd[h + "mlp.c_proj.bias"]},
            },
        }
    return kwargs, params


def gpt2_from_hf(hf_model, dtype=None, device=None) -> Tuple[GPT, dict]:
    """(GPT, state_dict) from a transformers GPT2LMHeadModel (or
    GPT2Model): the fused Conv1D c_attn [in, 3 * out] splits into q/k/v.

    `dtype` is the compute dtype (bf16 by default; float32 for exact
    verification on the CPU), `device` the model's (CUDA by default,
    `utils.devices.resolve_device`). Every converter takes both."""
    return _build(*_gpt2(hf_model), dtype, device)


def _llama(hf_model, dense_mlp: bool = True):
    """(GPT kwargs, flax params) of the LLaMA arrangement; without
    `dense_mlp` the blocks get no `mlp` subtree (the routed families add
    their `moe` subtree in its place)."""
    cfg = hf_model.config
    rope_scaling = _rope_scaling_tuple(
        getattr(cfg, "rope_scaling", None),
        max_position=cfg.max_position_embeddings,
    )
    if getattr(cfg, "attention_bias", False) or getattr(cfg, "mlp_bias", False):
        raise NotImplementedError(
            "checkpoints with attention_bias/mlp_bias are not supported by "
            "this converter (the bias tensors would be silently dropped)"
        )
    heads = cfg.num_attention_heads
    hidden = cfg.hidden_size
    # Gemma-7b-class checkpoints decouple the per-head width from
    # hidden/heads; honor the config's head_dim when present
    hd = getattr(cfg, "head_dim", None) or hidden // heads
    kv = cfg.num_key_value_heads
    tied = bool(getattr(cfg, "tie_word_embeddings", False))
    kwargs = dict(
        vocab_size=cfg.vocab_size, hidden_size=hidden,
        depth=cfg.num_hidden_layers, num_heads=heads,
        mlp_dim=cfg.intermediate_size,
        max_position=cfg.max_position_embeddings, position="rope",
        rope_theta=float(cfg.rope_theta), rope_scaling=rope_scaling,
        num_kv_heads=kv, norm="rms", mlp_act="swiglu", use_bias=False,
        tie_embeddings=tied, ln_eps=cfg.rms_norm_eps,
        head_dim=None if hd == hidden // heads else hd)
    sd = _sd(hf_model)
    pre = _prefix(sd, "model.")
    params = {
        "wte": {"embedding": sd[f"{pre}embed_tokens.weight"]},
        "decoder": {
            "ln_final": {"scale": sd[f"{pre}norm.weight"]},
        },
    }
    if not tied:
        params["lm_head"] = {"kernel": sd["lm_head.weight"].T}
    for i in range(cfg.num_hidden_layers):
        h = f"{pre}layers.{i}."
        params["decoder"][f"block_{i}"] = {
            "ln_attn": {"scale": sd[h + "input_layernorm.weight"]},
            "ln_mlp": {"scale": sd[h + "post_attention_layernorm.weight"]},
            "attn": {
                # torch Linear [out, in] -> in-major kernels
                "query": {"kernel": sd[h + "self_attn.q_proj.weight"].T
                          .reshape(hidden, heads, hd)},
                "key": {"kernel": sd[h + "self_attn.k_proj.weight"].T
                        .reshape(hidden, kv, hd)},
                "value": {"kernel": sd[h + "self_attn.v_proj.weight"].T
                          .reshape(hidden, kv, hd)},
                "out": {"kernel": sd[h + "self_attn.o_proj.weight"].T
                        .reshape(heads, hd, hidden)},
            },
        }
        if dense_mlp:
            params["decoder"][f"block_{i}"]["mlp"] = {
                "gate": {"kernel": sd[h + "mlp.gate_proj.weight"].T},
                "fc1": {"kernel": sd[h + "mlp.up_proj.weight"].T},
                "fc2": {"kernel": sd[h + "mlp.down_proj.weight"].T},
            }
    return kwargs, params


def _qkv_biases(hf_model, params: dict) -> None:
    """Add the Qwen2 q/k/v biases to a `_llama` tree, in place."""
    cfg = hf_model.config
    heads = cfg.num_attention_heads
    hd = getattr(cfg, "head_dim", None) or cfg.hidden_size // heads
    kv = cfg.num_key_value_heads
    sd = hf_model.state_dict()
    pre = _prefix(sd, "model.")
    for i in range(cfg.num_hidden_layers):
        h = f"{pre}layers.{i}.self_attn."
        attn = params["decoder"][f"block_{i}"]["attn"]
        attn["query"]["bias"] = _np(sd[h + "q_proj.bias"]).reshape(heads, hd)
        attn["key"]["bias"] = _np(sd[h + "k_proj.bias"]).reshape(kv, hd)
        attn["value"]["bias"] = _np(sd[h + "v_proj.bias"]).reshape(kv, hd)


def llama_from_hf(hf_model, dtype=None, device=None) -> Tuple[GPT, dict]:
    """(GPT, state_dict) from a transformers LlamaForCausalLM — the LLaMA
    family maps onto GPT(position='rope', num_kv_heads=..., norm='rms',
    mlp_act='swiglu', use_bias=False): rotary rotate-half, grouped-query
    K/V, RMSNorm (scale only), gated-silu MLP, bias-free projections, and
    an untied lm_head unless the checkpoint ties it."""
    return _build(*_llama(hf_model), dtype, device)


def mistral_from_hf(hf_model, dtype=None, device=None) -> Tuple[GPT, dict]:
    """(GPT, state_dict) from a transformers MistralForCausalLM: the LLaMA
    mapping plus `sliding_window` from the config (None there means full
    attention — some later Mistral checkpoints disable the window)."""
    kwargs, params = _llama(hf_model)
    window = getattr(hf_model.config, "sliding_window", None)
    if window is not None:
        kwargs["sliding_window"] = int(window)
    return _build(kwargs, params, dtype, device)


def gemma_from_hf(hf_model, dtype=None, device=None) -> Tuple[GPT, dict]:
    """(GPT, state_dict) from a transformers GemmaForCausalLM: the LLaMA
    mapping with the three Gemma deltas — the gelu-gated MLP
    (`mlp_act='geglu'`, HF gelu_pytorch_tanh), token embeddings scaled by
    sqrt(hidden) (`embed_scale`), and zero-centred RMSNorm weights (HF
    computes `x * (1 + w)`), folded into the stored scales as `1 + w` so
    the plain RMSNorm reproduces the math."""
    cfg = hf_model.config
    # hidden_act is what the installed GemmaMLP actually runs
    # (ACT2FN[config.hidden_act]); hidden_activation is a config-era alias
    # that GemmaConfig folds into it — validating the alias could pass a
    # checkpoint whose live field says something else
    act = getattr(cfg, "hidden_act", None)
    if act not in ("gelu_pytorch_tanh", "gelu_tanh", None):
        raise NotImplementedError(
            f"hidden_act {act!r} is not supported (expected the Gemma "
            f"tanh-gelu); converting would silently change the math"
        )
    if not bool(getattr(cfg, "tie_word_embeddings", True)):
        # every Gemma release ties; an untied fine-tune would carry a
        # distinct lm_head.weight this path would silently drop
        raise NotImplementedError(
            "untied Gemma-architecture checkpoints are not supported "
            "(lm_head.weight would be silently dropped)"
        )
    kwargs, params = _llama(hf_model)
    kwargs.update(mlp_act="geglu", tie_embeddings=True,
                  embed_scale=float(cfg.hidden_size) ** 0.5)
    dec = params["decoder"]
    dec["ln_final"]["scale"] = 1.0 + dec["ln_final"]["scale"]
    for i in range(cfg.num_hidden_layers):
        blk = dec[f"block_{i}"]
        blk["ln_attn"]["scale"] = 1.0 + blk["ln_attn"]["scale"]
        blk["ln_mlp"]["scale"] = 1.0 + blk["ln_mlp"]["scale"]
    return _build(kwargs, params, dtype, device)


def gemma2_from_hf(hf_model, dtype=None, device=None) -> Tuple[GPT, dict]:
    """(GPT, state_dict) from a transformers Gemma2ForCausalLM: the Gemma
    arrangement with sandwich norms (`norm_style='sandwich'`, four
    RMSNorms a block), the attention softcap and query scale
    (`attn_logit_cap`, `attn_scale = query_pre_attn_scalar^-0.5`), the
    final logit softcap, and alternating local/global attention (even
    blocks windowed: `sliding_window_pattern='alternate'`). All five norm
    kinds carry the 1 + w fold."""
    cfg = hf_model.config
    act = getattr(cfg, "hidden_activation", "gelu_pytorch_tanh")
    if act not in ("gelu_pytorch_tanh", "gelu_tanh"):
        raise NotImplementedError(
            f"hidden_activation {act!r} is not supported (expected the "
            f"Gemma tanh-gelu)"
        )
    if not bool(getattr(cfg, "tie_word_embeddings", True)):
        raise NotImplementedError(
            "untied Gemma-2 checkpoints are not supported"
        )
    if bool(getattr(cfg, "attention_bias", False)):
        raise NotImplementedError(
            "attention_bias=True checkpoints are not supported (the bias "
            "tensors would be silently dropped)"
        )
    lt = getattr(cfg, "layer_types", None)
    if lt is not None:
        expect = ["sliding_attention", "full_attention"]
        if any(t != expect[i % 2] for i, t in enumerate(lt)):
            raise NotImplementedError(
                f"layer_types {lt!r} does not match the Gemma-2 "
                f"even-sliding/odd-full interleave this model expresses"
            )
    heads = cfg.num_attention_heads
    hidden = cfg.hidden_size
    hd = cfg.head_dim
    kv = cfg.num_key_value_heads
    kwargs = dict(
        vocab_size=cfg.vocab_size, hidden_size=hidden,
        depth=cfg.num_hidden_layers, num_heads=heads,
        head_dim=None if hd == hidden // heads else hd,
        mlp_dim=cfg.intermediate_size,
        max_position=cfg.max_position_embeddings, position="rope",
        rope_theta=float(cfg.rope_theta), num_kv_heads=kv, use_bias=False,
        norm="rms", norm_style="sandwich", mlp_act="geglu",
        tie_embeddings=True, embed_scale=float(hidden) ** 0.5,
        ln_eps=cfg.rms_norm_eps, sliding_window=cfg.sliding_window,
        sliding_window_pattern="alternate",
        attn_scale=float(cfg.query_pre_attn_scalar) ** -0.5,
        attn_logit_cap=(float(cfg.attn_logit_softcapping)
                        if cfg.attn_logit_softcapping else None),
        final_logit_cap=(float(cfg.final_logit_softcapping)
                         if cfg.final_logit_softcapping else None))
    sd = _sd(hf_model)
    pre = _prefix(sd, "model.")

    def fold(w):  # zero-centered RMSNorm weights: stored scale = 1 + w
        return 1.0 + w

    params = {
        "wte": {"embedding": sd[f"{pre}embed_tokens.weight"]},
        "decoder": {
            "ln_final": {"scale": fold(sd[f"{pre}norm.weight"])},
        },
    }
    for i in range(cfg.num_hidden_layers):
        h = f"{pre}layers.{i}."
        params["decoder"][f"block_{i}"] = {
            "ln_attn": {"scale": fold(sd[h + "input_layernorm.weight"])},
            "ln_attn_post": {
                "scale": fold(sd[h + "post_attention_layernorm.weight"])
            },
            "ln_mlp": {
                "scale": fold(sd[h + "pre_feedforward_layernorm.weight"])
            },
            "ln_mlp_post": {
                "scale": fold(sd[h + "post_feedforward_layernorm.weight"])
            },
            "attn": {
                "query": {"kernel": sd[h + "self_attn.q_proj.weight"].T
                          .reshape(hidden, heads, hd)},
                "key": {"kernel": sd[h + "self_attn.k_proj.weight"].T
                        .reshape(hidden, kv, hd)},
                "value": {"kernel": sd[h + "self_attn.v_proj.weight"].T
                          .reshape(hidden, kv, hd)},
                "out": {"kernel": sd[h + "self_attn.o_proj.weight"].T
                        .reshape(heads, hd, hidden)},
            },
            "mlp": {
                "gate": {"kernel": sd[h + "mlp.gate_proj.weight"].T},
                "fc1": {"kernel": sd[h + "mlp.up_proj.weight"].T},
                "fc2": {"kernel": sd[h + "mlp.down_proj.weight"].T},
            },
        }
    return _build(kwargs, params, dtype, device)


def qwen2_from_hf(hf_model, dtype=None, device=None) -> Tuple[GPT, dict]:
    """(GPT, state_dict) from a transformers Qwen2ForCausalLM: the LLaMA
    mapping plus the q/k/v biases beside a bias-free out projection and
    MLP (`qkv_bias=True`). Sliding-window Qwen2 configs interleave
    windowed and full layers, which the single-window GPT cannot express —
    refused; every mainline release ships use_sliding_window=False."""
    cfg = hf_model.config
    if bool(getattr(cfg, "use_sliding_window", False)):
        raise NotImplementedError(
            "use_sliding_window=True interleaves windowed and full "
            "attention per layer (max_window_layers), which the "
            "single-window model cannot express; mainline Qwen2 releases "
            "ship with it disabled"
        )
    kwargs, params = _llama(hf_model)
    kwargs["qkv_bias"] = True
    _qkv_biases(hf_model, params)
    return _build(kwargs, params, dtype, device)


def qwen3_from_hf(hf_model, dtype=None, device=None) -> Tuple[GPT, dict]:
    """(GPT, state_dict) from a transformers Qwen3ForCausalLM: the
    bias-free LLaMA mapping plus the per-head RMSNorm on q and k before
    rotary (`qk_norm=True`, one [head_dim] scale each, shared by the
    heads) and a decoupled head_dim."""
    cfg = hf_model.config
    kwargs, params = _llama(hf_model)
    kwargs["qk_norm"] = True
    sd = hf_model.state_dict()
    pre = _prefix(sd, "model.")
    for i in range(cfg.num_hidden_layers):
        h = f"{pre}layers.{i}.self_attn."
        attn = params["decoder"][f"block_{i}"]["attn"]
        attn["q_norm"] = {"scale": _np(sd[h + "q_norm.weight"])}
        attn["k_norm"] = {"scale": _np(sd[h + "k_norm.weight"])}
    return _build(kwargs, params, dtype, device)


def phi3_from_hf(hf_model, dtype=None, device=None) -> Tuple[GPT, dict]:
    """(GPT, state_dict) from a transformers Phi3ForCausalLM (Phi-3/3.5
    mini): the LLaMA arrangement with fused checkpoint layouts — qkv_proj
    packs [q | k | v] rows flat, gate_up_proj packs [gate | up] — split
    here. Long-context variants carry rope_scaling='longrope', which
    `_rope_scaling_tuple` refuses (the 4k-context releases ship none).
    partial_rotary_factor < 1 maps to `rope_dim`."""
    cfg = hf_model.config
    if getattr(cfg, "hidden_act", "silu") != "silu":
        raise NotImplementedError(
            f"hidden_act {cfg.hidden_act!r} is not supported (Phi-3 "
            f"releases use silu)"
        )
    heads = cfg.num_attention_heads
    hidden = cfg.hidden_size
    hd = hidden // heads
    kv = cfg.num_key_value_heads
    prf = float(getattr(cfg, "partial_rotary_factor", 1.0))
    rope_dim = None if prf == 1.0 else int(hd * prf)
    tied = bool(getattr(cfg, "tie_word_embeddings", False))
    kwargs = dict(
        vocab_size=cfg.vocab_size, hidden_size=hidden,
        depth=cfg.num_hidden_layers, num_heads=heads,
        mlp_dim=cfg.intermediate_size,
        max_position=cfg.max_position_embeddings, position="rope",
        rope_theta=float(cfg.rope_theta),
        rope_scaling=_rope_scaling_tuple(
            getattr(cfg, "rope_scaling", None),
            max_position=cfg.max_position_embeddings,
        ),
        rope_dim=rope_dim, num_kv_heads=kv, use_bias=False, norm="rms",
        mlp_act="swiglu",
        sliding_window=getattr(cfg, "sliding_window", None),
        tie_embeddings=tied, ln_eps=cfg.rms_norm_eps)
    sd = _sd(hf_model)
    pre = _prefix(sd, "model.")
    params = {
        "wte": {"embedding": sd[f"{pre}embed_tokens.weight"]},
        "decoder": {
            "ln_final": {"scale": sd[f"{pre}norm.weight"]},
        },
    }
    if not tied:
        params["lm_head"] = {"kernel": sd["lm_head.weight"].T}
    f = cfg.intermediate_size
    for i in range(cfg.num_hidden_layers):
        h = f"{pre}layers.{i}."
        qkv = sd[h + "self_attn.qkv_proj.weight"].T  # [d, H + 2*kv*hd]
        qw, kw, vw = np.split(
            qkv, [heads * hd, heads * hd + kv * hd], axis=1
        )
        gate_up = sd[h + "mlp.gate_up_proj.weight"].T  # [d, 2F]
        gw, uw = np.split(gate_up, [f], axis=1)
        params["decoder"][f"block_{i}"] = {
            "ln_attn": {"scale": sd[h + "input_layernorm.weight"]},
            "ln_mlp": {"scale": sd[h + "post_attention_layernorm.weight"]},
            "attn": {
                "query": {"kernel": qw.reshape(hidden, heads, hd)},
                "key": {"kernel": kw.reshape(hidden, kv, hd)},
                "value": {"kernel": vw.reshape(hidden, kv, hd)},
                "out": {"kernel": sd[h + "self_attn.o_proj.weight"].T
                        .reshape(heads, hd, hidden)},
            },
            "mlp": {
                "gate": {"kernel": gw},
                "fc1": {"kernel": uw},
                "fc2": {"kernel": sd[h + "mlp.down_proj.weight"].T},
            },
        }
    return _build(kwargs, params, dtype, device)


def phi_from_hf(hf_model, dtype=None, device=None) -> Tuple[GPT, dict]:
    """(GPT, state_dict) from a transformers PhiForCausalLM: parallel
    blocks (one LayerNorm feeding attention and MLP side by side —
    `norm_style='parallel'`), partial rotary (`rope_dim =
    partial_rotary_factor * head_dim`), tanh-gelu MLP, biases everywhere
    including the untied lm_head (`head_bias=True`)."""
    cfg = hf_model.config
    if getattr(cfg, "rope_scaling", None):
        raise NotImplementedError(
            f"rope_scaling={cfg.rope_scaling!r} is not supported; "
            f"converting would produce silently wrong logits — only plain "
            f"rope_theta Phi checkpoints convert today"
        )
    if bool(getattr(cfg, "qk_layernorm", False)):
        raise NotImplementedError(
            "qk_layernorm=True Phi checkpoints are not supported (the "
            "per-head q/k norms would be silently dropped)"
        )
    if getattr(cfg, "hidden_act", None) not in ("gelu_new", None):
        raise NotImplementedError(
            f"hidden_act {cfg.hidden_act!r} is not supported (expected "
            f"Phi's gelu_new, which our tanh-gelu Mlp matches exactly)"
        )
    heads = cfg.num_attention_heads
    hidden = cfg.hidden_size
    hd = hidden // heads
    kv = cfg.num_key_value_heads
    rope_dim = int(getattr(cfg, "partial_rotary_factor", 1.0) * hd)
    kwargs = dict(
        vocab_size=cfg.vocab_size, hidden_size=hidden,
        depth=cfg.num_hidden_layers, num_heads=heads,
        mlp_dim=cfg.intermediate_size,
        max_position=cfg.max_position_embeddings, position="rope",
        rope_theta=float(cfg.rope_theta),
        rope_dim=None if rope_dim == hd else rope_dim, num_kv_heads=kv,
        norm="layer", norm_style="parallel", mlp_act="gelu", use_bias=True,
        tie_embeddings=False, head_bias=True, ln_eps=cfg.layer_norm_eps)
    sd = _sd(hf_model)
    pre = _prefix(sd, "model.")
    params = {
        "wte": {"embedding": sd[f"{pre}embed_tokens.weight"]},
        "decoder": {
            "ln_final": {"scale": sd[f"{pre}final_layernorm.weight"],
                         "bias": sd[f"{pre}final_layernorm.bias"]},
        },
        "lm_head": {"kernel": sd["lm_head.weight"].T,
                    "bias": sd["lm_head.bias"]},
    }
    for i in range(cfg.num_hidden_layers):
        h = f"{pre}layers.{i}."
        params["decoder"][f"block_{i}"] = {
            # parallel blocks have ONE norm: input_layernorm -> ln_attn
            "ln_attn": {"scale": sd[h + "input_layernorm.weight"],
                        "bias": sd[h + "input_layernorm.bias"]},
            "attn": {
                "query": {"kernel": sd[h + "self_attn.q_proj.weight"].T
                          .reshape(hidden, heads, hd),
                          "bias": sd[h + "self_attn.q_proj.bias"]
                          .reshape(heads, hd)},
                "key": {"kernel": sd[h + "self_attn.k_proj.weight"].T
                        .reshape(hidden, kv, hd),
                        "bias": sd[h + "self_attn.k_proj.bias"]
                        .reshape(kv, hd)},
                "value": {"kernel": sd[h + "self_attn.v_proj.weight"].T
                          .reshape(hidden, kv, hd),
                          "bias": sd[h + "self_attn.v_proj.bias"]
                          .reshape(kv, hd)},
                "out": {"kernel": sd[h + "self_attn.dense.weight"].T
                        .reshape(heads, hd, hidden),
                        "bias": sd[h + "self_attn.dense.bias"]},
            },
            "mlp": {
                "fc1": {"kernel": sd[h + "mlp.fc1.weight"].T,
                        "bias": sd[h + "mlp.fc1.bias"]},
                "fc2": {"kernel": sd[h + "mlp.fc2.weight"].T,
                        "bias": sd[h + "mlp.fc2.bias"]},
            },
        }
    return _build(kwargs, params, dtype, device)


def neox_from_hf(hf_model, dtype=None, device=None) -> Tuple[GPT, dict]:
    """(GPT, state_dict) from a transformers GPTNeoXForCausalLM (the
    Pythia family): a parallel residual with separate attention and MLP
    LayerNorms (`norm_style='parallel2'`; use_parallel_residual=False
    maps to 'pre'), partial rotary (`rope_dim = rotary_pct * head_dim`),
    biased projections, an untied bias-free embed_out head. The fused
    query_key_value weight is per-head interleaved ([heads, 3, head_dim,
    hidden]) and is de-interleaved here. NeoX runs the erf gelu; the Mlp's
    is the tanh approximation (~1e-3 in activations)."""
    cfg = hf_model.config
    if getattr(cfg, "rope_scaling", None):
        raise NotImplementedError(
            f"rope_scaling={cfg.rope_scaling!r} is not supported; only "
            f"plain rotary_emb_base checkpoints convert today"
        )
    if getattr(cfg, "hidden_act", "gelu") not in ("gelu", "gelu_new",
                                                  "gelu_pytorch_tanh"):
        raise NotImplementedError(
            f"hidden_act {cfg.hidden_act!r} is not supported (expected a "
            f"gelu variant)"
        )
    if not bool(getattr(cfg, "attention_bias", True)):
        raise NotImplementedError(
            "attention_bias=False NeoX checkpoints are not supported (the "
            "converter maps the biased arrangement every Pythia release "
            "ships)"
        )
    heads = cfg.num_attention_heads
    hidden = cfg.hidden_size
    hd = hidden // heads
    rope_dim = int(hd * cfg.rotary_pct)
    if bool(getattr(cfg, "tie_word_embeddings", False)):
        raise NotImplementedError(
            "tied-embedding NeoX checkpoints are not supported (every "
            "Pythia release unties embed_out); the tied head would drop "
            "embed_out.weight silently"
        )
    kwargs = dict(
        vocab_size=cfg.vocab_size, hidden_size=hidden,
        depth=cfg.num_hidden_layers, num_heads=heads,
        mlp_dim=cfg.intermediate_size,
        max_position=cfg.max_position_embeddings, position="rope",
        rope_theta=float(getattr(cfg, "rotary_emb_base", 10_000.0)),
        rope_dim=None if rope_dim == hd else rope_dim, norm="layer",
        norm_style=("parallel2" if cfg.use_parallel_residual else "pre"),
        mlp_act="gelu", use_bias=True, tie_embeddings=False,
        ln_eps=cfg.layer_norm_eps)
    sd = _sd(hf_model)
    pre = _prefix(sd, "gpt_neox.")
    if "embed_out.weight" not in sd:
        raise NotImplementedError(
            "pass a GPTNeoXForCausalLM (with its embed_out head); a bare "
            "GPTNeoXModel has no LM head to map"
        )
    params = {
        "wte": {"embedding": sd[f"{pre}embed_in.weight"]},
        "decoder": {
            "ln_final": {"scale": sd[f"{pre}final_layer_norm.weight"],
                         "bias": sd[f"{pre}final_layer_norm.bias"]},
        },
        "lm_head": {"kernel": sd["embed_out.weight"].T},
    }
    for i in range(cfg.num_hidden_layers):
        h = f"{pre}layers.{i}."
        # [3H, H] rows are per-head interleaved: head h's q, then k, then v
        qkv_w = sd[h + "attention.query_key_value.weight"].reshape(
            heads, 3, hd, hidden
        )
        qkv_b = sd[h + "attention.query_key_value.bias"].reshape(
            heads, 3, hd
        )

        def proj(j):
            # [heads, hd, hidden] -> in-major [hidden, heads, hd]
            return {"kernel": qkv_w[:, j].transpose(2, 0, 1),
                    "bias": qkv_b[:, j]}

        params["decoder"][f"block_{i}"] = {
            "ln_attn": {"scale": sd[h + "input_layernorm.weight"],
                        "bias": sd[h + "input_layernorm.bias"]},
            "ln_mlp": {"scale": sd[h + "post_attention_layernorm.weight"],
                       "bias": sd[h + "post_attention_layernorm.bias"]},
            "attn": {
                "query": proj(0),
                "key": proj(1),
                "value": proj(2),
                "out": {"kernel": sd[h + "attention.dense.weight"].T
                        .reshape(heads, hd, hidden),
                        "bias": sd[h + "attention.dense.bias"]},
            },
            "mlp": {
                "fc1": {"kernel": sd[h + "mlp.dense_h_to_4h.weight"].T,
                        "bias": sd[h + "mlp.dense_h_to_4h.bias"]},
                "fc2": {"kernel": sd[h + "mlp.dense_4h_to_h.weight"].T,
                        "bias": sd[h + "mlp.dense_4h_to_h.bias"]},
            },
        }
    return _build(kwargs, params, dtype, device)


def bigcode_from_hf(hf_model, dtype=None, device=None) -> Tuple[GPT, dict]:
    """(GPT, state_dict) from a transformers GPTBigCodeForCausalLM (the
    StarCoder family): the GPT-2 arrangement (learned positions,
    LayerNorm, tanh-gelu, tied head, biased projections) with multi-query
    attention; the fused c_attn packs [q (H) | k (kv * hd) | v (kv * hd)]
    rows under multi_query and interleaves per head otherwise, split here
    into the three projection kernels."""
    cfg = hf_model.config
    if not bool(getattr(cfg, "scale_attn_weights", True)):
        raise NotImplementedError(
            "scale_attn_weights=False checkpoints are not supported (our "
            "attention always scales by 1/sqrt(head_dim))"
        )
    if getattr(cfg, "activation_function",
               "gelu_pytorch_tanh") not in ("gelu_pytorch_tanh",
                                            "gelu_new"):
        # exact-erf 'gelu' would convert with a silent ~1e-3 drift; the
        # tanh variants match our Mlp exactly
        raise NotImplementedError(
            f"activation_function {cfg.activation_function!r} is not "
            f"supported (expected the tanh-gelu variants "
            f"gelu_pytorch_tanh/gelu_new, which our Mlp matches exactly)"
        )
    heads = cfg.n_head
    hidden = cfg.n_embd
    hd = hidden // heads
    kv = 1 if cfg.multi_query else heads
    mlp_dim = cfg.n_inner if cfg.n_inner is not None else 4 * hidden
    kwargs = dict(
        vocab_size=cfg.vocab_size, hidden_size=hidden, depth=cfg.n_layer,
        num_heads=heads, mlp_dim=mlp_dim, max_position=cfg.n_positions,
        num_kv_heads=kv, ln_eps=cfg.layer_norm_epsilon)
    sd = _sd(hf_model)
    pre = _prefix(sd, "transformer.")
    params = {
        "wte": {"embedding": sd[f"{pre}wte.weight"]},
        "wpe": {"embedding": sd[f"{pre}wpe.weight"]},
        "decoder": {
            "ln_final": {"scale": sd[f"{pre}ln_f.weight"],
                         "bias": sd[f"{pre}ln_f.bias"]},
        },
    }
    for i in range(cfg.n_layer):
        h = f"{pre}h.{i}."
        # torch Linear [out, in] -> in-major, then split. The two fused
        # layouts differ: multi_query packs flat [Q (H) | K (hd) | V (hd)]
        # blocks; classic MHA interleaves PER HEAD ([q_h | k_h | v_h] for
        # each head — the .view(heads, 3*hd) split in the HF forward)
        w = sd[h + "attn.c_attn.weight"].T
        b = sd[h + "attn.c_attn.bias"]
        if cfg.multi_query:
            qw, kw, vw = np.split(w, [hidden, hidden + kv * hd], axis=1)
            qb, kb, vb = np.split(b, [hidden, hidden + kv * hd])
        else:
            w4 = w.reshape(hidden, heads, 3, hd)
            b3 = b.reshape(heads, 3, hd)
            qw, kw, vw = w4[:, :, 0], w4[:, :, 1], w4[:, :, 2]
            qb, kb, vb = b3[:, 0], b3[:, 1], b3[:, 2]
        params["decoder"][f"block_{i}"] = {
            "ln_attn": {"scale": sd[h + "ln_1.weight"],
                        "bias": sd[h + "ln_1.bias"]},
            "ln_mlp": {"scale": sd[h + "ln_2.weight"],
                       "bias": sd[h + "ln_2.bias"]},
            "attn": {
                "query": {"kernel": qw.reshape(hidden, heads, hd),
                          "bias": qb.reshape(heads, hd)},
                "key": {"kernel": kw.reshape(hidden, kv, hd),
                        "bias": kb.reshape(kv, hd)},
                "value": {"kernel": vw.reshape(hidden, kv, hd),
                          "bias": vb.reshape(kv, hd)},
                "out": {"kernel": sd[h + "attn.c_proj.weight"].T
                        .reshape(heads, hd, hidden),
                        "bias": sd[h + "attn.c_proj.bias"]},
            },
            "mlp": {
                "fc1": {"kernel": sd[h + "mlp.c_fc.weight"].T,
                        "bias": sd[h + "mlp.c_fc.bias"]},
                "fc2": {"kernel": sd[h + "mlp.c_proj.weight"].T,
                        "bias": sd[h + "mlp.c_proj.bias"]},
            },
        }
    return _build(kwargs, params, dtype, device)


def opt_from_hf(hf_model, dtype=None, device=None) -> Tuple[GPT, dict]:
    """(GPT, state_dict) from a transformers OPTForCausalLM: pre-LN
    blocks, relu MLP, learned positions with the legacy offset-2 table
    (the first two rows are sliced off: position i uses HF row i + 2, so
    the 0-based lookup hits the same vector), biased projections, tied
    head, final LayerNorm. Projected-embedding checkpoints
    (word_embed_proj_dim != hidden, e.g. opt-350m, also the only post-LN
    release) are refused."""
    cfg = hf_model.config
    if cfg.word_embed_proj_dim != cfg.hidden_size:
        raise NotImplementedError(
            f"word_embed_proj_dim {cfg.word_embed_proj_dim} != hidden "
            f"{cfg.hidden_size}: projected-embedding OPT checkpoints "
            f"(opt-350m) are not supported"
        )
    if not bool(getattr(cfg, "do_layer_norm_before", True)):
        raise NotImplementedError(
            "do_layer_norm_before=False (post-LN OPT) is not supported"
        )
    if bool(getattr(cfg, "_remove_final_layer_norm", False)):
        raise NotImplementedError(
            "_remove_final_layer_norm=True (pre-release metaseq "
            "conversions) is not supported — the checkpoint has no "
            "final LayerNorm to map"
        )
    if not bool(getattr(cfg, "enable_bias", True)) or not bool(
            getattr(cfg, "layer_norm_elementwise_affine", True)):
        raise NotImplementedError(
            "bias-free / non-affine-LN OPT variants are not supported"
        )
    if getattr(cfg, "activation_function", "relu") != "relu":
        raise NotImplementedError(
            f"activation_function {cfg.activation_function!r} is not "
            f"supported (OPT releases use relu)"
        )
    if not bool(getattr(cfg, "tie_word_embeddings", True)):
        raise NotImplementedError(
            "untied OPT checkpoints are not supported (lm_head.weight "
            "would be silently dropped)"
        )
    heads = cfg.num_attention_heads
    hidden = cfg.hidden_size
    hd = hidden // heads
    kwargs = dict(
        vocab_size=cfg.vocab_size, hidden_size=hidden,
        depth=cfg.num_hidden_layers, num_heads=heads, mlp_dim=cfg.ffn_dim,
        max_position=cfg.max_position_embeddings, mlp_act="relu",
        tie_embeddings=True,
        ln_eps=1e-5)  # torch nn.LayerNorm default, what OPT runs
    sd = _sd(hf_model)
    pre = ("model.decoder."
           if any(k.startswith("model.decoder.") for k in sd)
           else "decoder." if any(k.startswith("decoder.") for k in sd)
           else "")
    params = {
        "wte": {"embedding": sd[f"{pre}embed_tokens.weight"]},
        # drop the legacy offset rows: HF looks up row i+2 for position i
        "wpe": {"embedding": sd[f"{pre}embed_positions.weight"][2:]},
        "decoder": {
            "ln_final": {"scale": sd[f"{pre}final_layer_norm.weight"],
                         "bias": sd[f"{pre}final_layer_norm.bias"]},
        },
    }
    for i in range(cfg.num_hidden_layers):
        h = f"{pre}layers.{i}."
        params["decoder"][f"block_{i}"] = {
            "ln_attn": {"scale": sd[h + "self_attn_layer_norm.weight"],
                        "bias": sd[h + "self_attn_layer_norm.bias"]},
            "ln_mlp": {"scale": sd[h + "final_layer_norm.weight"],
                       "bias": sd[h + "final_layer_norm.bias"]},
            "attn": {
                "query": {"kernel": sd[h + "self_attn.q_proj.weight"].T
                          .reshape(hidden, heads, hd),
                          "bias": sd[h + "self_attn.q_proj.bias"]
                          .reshape(heads, hd)},
                "key": {"kernel": sd[h + "self_attn.k_proj.weight"].T
                        .reshape(hidden, heads, hd),
                        "bias": sd[h + "self_attn.k_proj.bias"]
                        .reshape(heads, hd)},
                "value": {"kernel": sd[h + "self_attn.v_proj.weight"].T
                          .reshape(hidden, heads, hd),
                          "bias": sd[h + "self_attn.v_proj.bias"]
                          .reshape(heads, hd)},
                "out": {"kernel": sd[h + "self_attn.out_proj.weight"].T
                        .reshape(heads, hd, hidden),
                        "bias": sd[h + "self_attn.out_proj.bias"]},
            },
            "mlp": {
                "fc1": {"kernel": sd[h + "fc1.weight"].T,
                        "bias": sd[h + "fc1.bias"]},
                "fc2": {"kernel": sd[h + "fc2.weight"].T,
                        "bias": sd[h + "fc2.bias"]},
            },
        }
    return _build(kwargs, params, dtype, device)


def falcon_from_hf(hf_model, dtype=None, device=None) -> Tuple[GPT, dict]:
    """(GPT, state_dict) from a transformers FalconForCausalLM, in its
    three arrangements: the 7B shape (multi_query + parallel_attn: one
    LayerNorm feeding attention and MLP — `norm_style='parallel'`, one KV
    head), the 40B/180B shape (new_decoder_architecture: separate
    ln_attn/ln_mlp on a parallel residual — 'parallel2', grouped KV; one
    shared norm when num_ln_in_parallel_attn == 1, the Falcon2-11B form),
    and the sequential pre-LN shape (parallel_attn=False). All are rope
    and bias-free Linears beside biased LayerNorms. The fused
    query_key_value weight unpacks per arrangement. alibi checkpoints
    (falcon-rw), bias=True Linears and rope scaling are refused. Falcon's
    MLP runs the erf gelu; the Mlp's is the tanh approximation (~1e-3)."""
    cfg = hf_model.config
    if bool(getattr(cfg, "alibi", False)):
        raise NotImplementedError(
            "alibi Falcon checkpoints (falcon-rw) are not supported — "
            "the position machinery here is rope/learned, not alibi"
        )
    if bool(getattr(cfg, "bias", False)):
        raise NotImplementedError(
            "bias=True Falcon variants are not supported (the mainline "
            "7B/40B/180B releases are bias-free)"
        )
    if getattr(cfg, "rope_scaling", None):
        raise NotImplementedError(
            f"rope_scaling {cfg.rope_scaling!r} is not supported — "
            f"converting would silently apply unscaled rotary embeddings"
        )
    act = getattr(cfg, "activation", "gelu")
    if act not in ("gelu", "gelu_new", "gelu_pytorch_tanh"):
        raise NotImplementedError(
            f"activation {act!r} is not supported (Falcon releases use "
            f"gelu; converting would silently change the math)"
        )
    heads = cfg.num_attention_heads
    hidden = cfg.hidden_size
    hd = hidden // heads
    new_arch = bool(getattr(cfg, "new_decoder_architecture", False))
    # LN arrangement: the 40B/180B new-arch form carries TWO parallel LNs
    # (parallel2) UNLESS num_ln_in_parallel_attn == 1 (the Falcon2-11B
    # form: grouped kv but ONE shared LN — 'parallel'); pre-new-arch
    # models have one LN when parallel_attn, two sequential otherwise
    if new_arch:
        kv = cfg.num_kv_heads
        two_ln = getattr(cfg, "num_ln_in_parallel_attn", None) != 1
        norm_style = "parallel2" if two_ln else "parallel"
    else:
        kv = 1 if bool(getattr(cfg, "multi_query", True)) else heads
        norm_style = ("parallel" if getattr(cfg, "parallel_attn", True)
                      else "pre")
    tied = bool(getattr(cfg, "tie_word_embeddings", True))
    kwargs = dict(
        vocab_size=cfg.vocab_size, hidden_size=hidden,
        depth=cfg.num_hidden_layers, num_heads=heads,
        mlp_dim=getattr(cfg, "ffn_hidden_size", None) or 4 * hidden,
        max_position=getattr(cfg, "max_position_embeddings", 2048),
        position="rope",
        rope_theta=float(getattr(cfg, "rope_theta", 10_000.0)),
        num_kv_heads=kv, use_bias=False, norm="layer",
        norm_style=norm_style, tie_embeddings=tied,
        ln_eps=cfg.layer_norm_epsilon)
    sd = _sd(hf_model)
    pre = _prefix(sd, "transformer.")
    params = {
        "wte": {"embedding": sd[f"{pre}word_embeddings.weight"]},
        "decoder": {
            "ln_final": {"scale": sd[f"{pre}ln_f.weight"],
                         "bias": sd[f"{pre}ln_f.bias"]},
        },
    }
    if not tied:
        params["lm_head"] = {"kernel": sd["lm_head.weight"].T}
    g = heads // kv
    for i in range(cfg.num_hidden_layers):
        h = f"{pre}h.{i}."
        w = sd[h + "self_attention.query_key_value.weight"].T  # [in, out]
        if new_arch:
            # [hidden, kv, g+2, hd]: per-KV-group [g q | k | v]
            w4 = w.reshape(hidden, kv, g + 2, hd)
            qw = w4[:, :, :g].reshape(hidden, heads, hd)
            kw = w4[:, :, g]
            vw = w4[:, :, g + 1]
        elif kv == 1:
            # flat [Q (H) | k (hd) | v (hd)]
            qw, kw, vw = np.split(w, [hidden, hidden + hd], axis=1)
            qw = qw.reshape(hidden, heads, hd)
            kw = kw.reshape(hidden, 1, hd)
            vw = vw.reshape(hidden, 1, hd)
        else:
            # classic MHA: per-head [q_h | k_h | v_h] interleave
            w4 = w.reshape(hidden, heads, 3, hd)
            qw, kw, vw = w4[:, :, 0], w4[:, :, 1], w4[:, :, 2]
        blk = {
            "attn": {
                "query": {"kernel": qw},
                "key": {"kernel": kw},
                "value": {"kernel": vw},
                "out": {"kernel": sd[h + "self_attention.dense.weight"].T
                        .reshape(heads, hd, hidden)},
            },
            "mlp": {
                "fc1": {"kernel": sd[h + "mlp.dense_h_to_4h.weight"].T},
                "fc2": {"kernel": sd[h + "mlp.dense_4h_to_h.weight"].T},
            },
        }
        if norm_style == "parallel2":
            blk["ln_attn"] = {"scale": sd[h + "ln_attn.weight"],
                              "bias": sd[h + "ln_attn.bias"]}
            blk["ln_mlp"] = {"scale": sd[h + "ln_mlp.weight"],
                             "bias": sd[h + "ln_mlp.bias"]}
        else:
            # 'parallel' (one LN — 7B and the new-arch Falcon2-11B form
            # alike) and 'pre' both read input_layernorm
            blk["ln_attn"] = {"scale": sd[h + "input_layernorm.weight"],
                              "bias": sd[h + "input_layernorm.bias"]}
            if norm_style == "pre":
                blk["ln_mlp"] = {
                    "scale": sd[h + "post_attention_layernorm.weight"],
                    "bias": sd[h + "post_attention_layernorm.bias"],
                }
        params["decoder"][f"block_{i}"] = blk
    return _build(kwargs, params, dtype, device)


def _routed(hf_model, kwargs: dict, params: dict, e: int, k: int,
            moe_of) -> None:
    """Turn a `_llama(hf_model, dense_mlp=False)` tree into the routed
    one, in place: every block's `moe` subtree from `moe_of(sd, h)` (h the
    layer's prefix), and the MoE fields at the dropless capacity E / k."""
    kwargs.update(num_experts=e, moe_every=1, experts_per_token=k,
                  moe_capacity_factor=float(e) / k)
    sd = _sd(hf_model)
    pre = _prefix(sd, "model.")
    for i in range(hf_model.config.num_hidden_layers):
        params["decoder"][f"block_{i}"]["moe"] = moe_of(
            sd, f"{pre}layers.{i}.")


def _experts(sd, prefix: str, e: int, names) -> dict:
    """{flax name: the [E, in, out] stack of the per-expert torch Linears
    ([out, in]) `prefix + f"experts.{j}.{w}.weight"`} for (flax name, w)
    in `names`."""
    return {name: np.stack([sd[prefix + f"experts.{j}.{w}.weight"].T
                            for j in range(e)])
            for name, w in names}


def qwen2moe_from_hf(hf_model, dtype=None, device=None) -> Tuple[GPT, dict]:
    """(GPT, state_dict) from a transformers Qwen2MoeForCausalLM.

    Qwen2-MoE = the Qwen2 attention arrangement (biased q/k/v beside
    bias-free o/MLP) with EVERY layer's MLP routed, plus two deltas the
    MoE layer grew for it: RAW top-k combine weights
    (`moe_normalize_topk=False` when norm_topk_prob is off — the released
    A2.7B config) and a dense SHARED expert beside the routed ones, its
    output scaled by a learned sigmoid gate
    (`moe_shared_expert_dim`). Conversion pins the no-drop capacity
    (E/k) like Mixtral, making the converted forward exact."""
    cfg = hf_model.config
    if list(getattr(cfg, "mlp_only_layers", []) or []):
        raise NotImplementedError(
            f"mlp_only_layers {cfg.mlp_only_layers!r} (dense layers "
            f"interleaved among MoE) is not supported — the released "
            f"Qwen2-MoE configs route every layer"
        )
    if int(getattr(cfg, "decoder_sparse_step", 1)) != 1:
        raise NotImplementedError(
            f"decoder_sparse_step {cfg.decoder_sparse_step} != 1 is not "
            f"supported"
        )
    if bool(getattr(cfg, "use_sliding_window", False)):
        raise NotImplementedError(
            "use_sliding_window=True is not supported (per-layer windows)"
        )
    kwargs, params = _llama(hf_model, dense_mlp=False)
    _qkv_biases(hf_model, params)
    kwargs.update(qkv_bias=True, mlp_dim=cfg.moe_intermediate_size,
                  moe_normalize_topk=bool(getattr(cfg, "norm_topk_prob",
                                                  False)),
                  moe_shared_expert_dim=cfg.shared_expert_intermediate_size)

    def moe(sd, h):
        m = h + "mlp."
        return {
            "router": {"kernel": sd[m + "gate.weight"].T},
            **_experts(sd, m, cfg.num_experts,
                       (("experts_gate", "gate_proj"),
                        ("experts_fc1", "up_proj"),
                        ("experts_fc2", "down_proj"))),
            **{name: {"kernel": sd[m + f"shared_expert.{proj}.weight"].T}
               for name, proj in (("shared_gate", "gate_proj"),
                                  ("shared_fc1", "up_proj"),
                                  ("shared_fc2", "down_proj"))},
            "shared_expert_gate": {
                "kernel": sd[m + "shared_expert_gate.weight"].T}}

    _routed(hf_model, kwargs, params, cfg.num_experts,
            cfg.num_experts_per_tok, moe)
    return _build(kwargs, params, dtype, device)


def mixtral_from_hf(hf_model, dtype=None, device=None) -> Tuple[GPT, dict]:
    """(GPT, state_dict) from a transformers MixtralForCausalLM — the
    routed sparse-MoE LLaMA: every layer's MLP is a top-k gated expert
    mixture (w1=gate, w3=up, w2=down per expert, silu-gated),
    attention/norms are the LLaMA arrangement.

    Maps to GPT(num_experts=E, moe_every=1, mlp_act='swiglu',
    use_bias=False) over models/moe.MoEMlp with experts_gate beside
    experts_fc1/fc2. Routing parity: both sides softmax the full router
    logits, take top-k, and renormalize the kept gates; Mixtral drops NO
    tokens, so conversion pins `moe_capacity_factor = E / k` — per-group
    capacity C = m (every token could route to one expert), making the
    converted forward exact; the port's layer reaches that capacity
    without the JAX layer's O(m^2 E) one-hot (`models/moe.py`).
    Fine-tuning configs can lower the factor; serving parity keeps it."""
    cfg = hf_model.config
    kwargs, params = _llama(hf_model, dense_mlp=False)
    kwargs["sliding_window"] = getattr(cfg, "sliding_window", None)
    e = cfg.num_local_experts

    def moe(sd, h):
        m = h + "block_sparse_moe."
        return {"router": {"kernel": sd[m + "gate.weight"].T},
                **_experts(sd, m, e, (("experts_gate", "w1"),
                                      ("experts_fc1", "w3"),
                                      ("experts_fc2", "w2")))}

    _routed(hf_model, kwargs, params, e, cfg.num_experts_per_tok, moe)
    return _build(kwargs, params, dtype, device)


def _read_config(artifact_dir: str) -> dict:
    """The artifact's model_config.json as a dict."""
    with open(os.path.join(artifact_dir, "model_config.json")) as f:
        return json.load(f)


def save_converted(model: GPT, out_dir: str, family: str) -> str:
    """Write `model` as a conversion artifact (params.npz +
    model_config.json) in the JAX package's layout: the flax-layout
    params (`to_flax_params`) under flat '/' keys, and every field of the
    JAX `GPT` (the port's `model.config`, the unported ones at their
    defaults), the family and the compute dtype's numpy name. JAX's
    `load_converted` reads it as it reads its own. Returns `out_dir`."""
    if family not in _FAMILIES:
        raise ValueError(f"unknown family {family!r}; one of "
                         f"{sorted(_FAMILIES)}")
    os.makedirs(out_dir, exist_ok=True)
    write_params_npz(os.path.join(out_dir, "params.npz"),
                     to_flax_params(model))
    config = {**_UNPORTED, **model.config, "family": family,
              "dtype": str(model.dtype).removeprefix("torch.")}
    with open(os.path.join(out_dir, "model_config.json"), "w") as f:
        json.dump(config, f, indent=2)
    return out_dir


def load_converted(artifact_dir: str, dtype: Optional[torch.dtype] = None,
                   device=None) -> GPT:
    """The GPT of a conversion artifact written by either package's
    `save_converted` (or conversion CLI), its weights loaded, on `device`
    (CUDA by default, `utils.devices.resolve_device`). `dtype` overrides
    the recorded compute dtype (e.g. torch.float32 on the CPU).

    The recorded fields go to `GPT`: a field the port does not implement
    raises NotImplementedError at a value other than its default (e.g.
    `quant`), a name the JAX `GPT` lacks TypeError. JAX
    also records `decode`, its serving-mode switch (the flax cache
    collection): the port's decode is the `cache` argument of the
    forward, so it is dropped."""
    conf = _read_config(artifact_dir)
    family = conf.pop("family")
    recorded = conf.pop("dtype")
    conf.pop("decode", None)
    if family in ("bert", "bert-classifier", "t5"):
        raise NotImplementedError(
            f"family {family!r} is not ported yet (ROADMAP.md, queue 1 "
            f"item 2); "
            f"the port loads the GPT families")
    if family not in _FAMILIES and family not in _UNPORTED_FAMILIES:
        raise ValueError(f"unknown family {family!r} in {artifact_dir}")
    # json stores tuples as lists (rope_scaling)
    kwargs = {k: tuple(v) if isinstance(v, list) else v
              for k, v in conf.items()}
    model = GPT(**kwargs, dtype=_DTYPES[recorded] if dtype is None else dtype,
                device=device)
    with np.load(os.path.join(artifact_dir, "params.npz")) as z:
        params = _unflatten({k: z[k] for k in z.files})
    model.load_state_dict(from_flax_params(params))
    return model


def _cli(argv=None) -> str:
    """Convert a local HF checkpoint directory into the artifact:
    <out>/params.npz + <out>/model_config.json. Returns the output dir.
    Offline by construction: `hf_path` is a local directory saved with
    save_pretrained(); nothing is downloaded. The conversion is host-side
    reshaping of a host checkpoint into a host file, so the model is
    built on the CPU; `serve_gpt --hf-dir` serves the artifact on the
    card."""
    import argparse

    parser = argparse.ArgumentParser(
        description="HF checkpoint -> tfde_tpu_torch conversion artifact")
    parser.add_argument("family",
                        choices=sorted((*_FAMILIES, *_UNPORTED_FAMILIES)))
    parser.add_argument("hf_path", help="local save_pretrained() directory")
    parser.add_argument("out_dir")
    args = parser.parse_args(argv)
    if args.family in _UNPORTED_FAMILIES:
        raise SystemExit(f"family {args.family!r} is not ported yet "
                         f"(ROADMAP.md, queue 1 item 2)")

    import transformers

    if not os.path.isdir(args.hf_path):
        raise SystemExit(
            f"{args.hf_path!r} is not a directory — pass a local "
            f"save_pretrained() checkpoint; this CLI never downloads"
        )
    cls_name, fn_name = _FAMILIES[args.family]
    hf = getattr(transformers, cls_name).from_pretrained(
        args.hf_path, local_files_only=True
    )
    hf.eval()
    model, _ = globals()[fn_name](hf, device="cpu")
    save_converted(model, args.out_dir, args.family)
    print(f"converted {args.family} checkpoint -> {args.out_dir}")
    return args.out_dir


if __name__ == "__main__":
    _cli()
