"""Flax params tree <-> torch state_dict, for shared-weight parity and
for the conversion artifact's `params.npz`.

The two frameworks' random initialisers never agree, so the port is held
against the JAX package on the SAME weights: the JAX params tree (as
numpy arrays — this module never imports flax or jax) goes through
`from_flax_params` into a state_dict for the port's modules. Layouts:

- Embed `embedding` [V, E]          -> `weight` [V, E]
- LayerNorm `scale` / `bias`        -> `weight` / `bias`
- RMSNorm `scale` (the block norms, `q_norm`/`k_norm`, `ln_attn_post`,
  `ln_mlp_post`)                    -> `weight`
- Dense `kernel` [in, out]          -> Linear `weight` [out, in]
- Conv `kernel` HWIO [kh, kw, in, out] -> Conv2d `weight` OIHW
- DenseGeneral q/k/v `kernel` [E, H, D] -> `weight` [H*D, E] (k/v
  [E, Kv, D] -> [Kv*D, E] under grouped-query attention; H*D need not be
  E: a decoupled head_dim)
- DenseGeneral `out` `kernel` [H, D, E] -> `weight` [E, H*D]
- Dense `gate` (swiglu, geglu) and the untied `lm_head` as any Dense
- any `bias` [...]                  -> flattened
- BatchNorm `batch_stats` `mean` / `var` -> buffers `running_mean` /
  `running_var`
- a raw `self.param` (`RAW_PARAMS`: ViT's `cls_token` [1, 1, E] and
  `pos_embed` [1, S, E], BERT's `mlm_bias` [V]) -> a parameter of the
  same name and shape

A Dense kernel after a flatten keeps its rows: the port's CNNs flatten
in NHWC order, as flax does (`models/cnn.py`). A BatchNorm `scale` lands
in `weight`, as a LayerNorm's does: the ResNet's params and batch_stats
(`conv_init`, `bn_init`, `BottleneckBlock_i/Conv_j`, `BatchNorm_j`,
`conv_proj`, `norm_proj`, `Dense_0`) map onto `models/resnet.py` by
these rules alone.

`to_flax_params(model)` is the exact inverse for the port's transformer
models (GPT): the numpy tree JAX's `GPT.apply` takes and the conversion
artifact stores.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch
from torch import nn

#: the flax parameters made by `self.param` (no layer around them), kept
#: under their own names and shapes
RAW_PARAMS = ("cls_token", "pos_embed", "mlm_bias")


def _convert(path: tuple, leaf) -> tuple:
    arr = np.asarray(leaf, dtype=np.float32)
    *mods, name = path
    if name == "kernel":
        if arr.ndim == 3 and mods[-1] == "out":
            arr = arr.reshape(-1, arr.shape[-1]).T   # [H, D, E] -> [E, H*D]
        elif arr.ndim == 3:
            arr = arr.reshape(arr.shape[0], -1).T    # [E, H, D] -> [H*D, E]
        elif arr.ndim == 2:
            arr = arr.T
        elif arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)          # HWIO -> OIHW
        else:
            raise ValueError(f"unexpected kernel rank {arr.ndim} at {path}")
        name = "weight"
    elif name in ("embedding", "scale"):
        name = "weight"
    elif name == "bias":
        arr = arr.reshape(-1)
    elif name in ("mean", "var"):
        name = f"running_{name}"
    elif name in RAW_PARAMS:
        pass
    else:
        raise ValueError(f"unknown flax param {'/'.join(path)}")
    return ".".join([*mods, name]), torch.tensor(np.ascontiguousarray(arr))


def from_flax_params(params: Mapping,
                     batch_stats: Optional[Mapping] = None) -> dict:
    """Nested {module: {param: array}} (the flax "params" collection, leaves
    as numpy arrays) -> {dotted torch name: fp32 tensor}; with
    `batch_stats` (the flax "batch_stats" collection) the BatchNorm
    running statistics join it."""
    out = {}

    def walk(node, path):
        if isinstance(node, Mapping):
            for key, child in node.items():
                walk(child, path + (str(key),))
        else:
            name, tensor = _convert(path, node)
            out[name] = tensor

    walk(params, ())
    if batch_stats is not None:
        walk(batch_stats, ())
    return out


def to_flax_params(model: nn.Module) -> dict:
    """The inverse of `from_flax_params` for a model built from `Dense`,
    `nn.Embedding`, `LayerNorm` and `RMSNorm` (`models/transformer.py`,
    `models/gpt.py`): {module: {param: fp32 numpy array}} in flax's
    layouts, the attention projections as DenseGeneral kernels ([E, H, D]
    for query/key/value, [H, D, E] for out, their biases [H, D] and [E]).
    Values are copied exactly (a bf16 weight widens to fp32)."""
    from tfde_tpu_torch.models.transformer import (
        Dense, LayerNorm, MultiHeadAttention, RMSNorm)

    tree: dict = {}
    mods = dict(model.named_modules())
    for name, mod in mods.items():
        params = {n: p.detach().float().cpu().numpy()
                  for n, p in mod.named_parameters(recurse=False)}
        if not params:
            continue
        *parent, leaf = name.split(".")
        owner = mods[".".join(parent)]
        if isinstance(mod, Dense):
            w, b = params["weight"], params.get("bias")
            if isinstance(owner, MultiHeadAttention) and leaf == "out":
                kernel = w.T.reshape(owner.num_heads, owner.head_dim, -1)
            elif isinstance(owner, MultiHeadAttention):
                hd = owner.head_dim
                kernel = w.T.reshape(w.shape[1], -1, hd)
                b = None if b is None else b.reshape(-1, hd)
            else:
                kernel = w.T
            flax = {"kernel": kernel}
            if b is not None:
                flax["bias"] = b
        elif isinstance(mod, nn.Embedding):
            flax = {"embedding": params["weight"]}
        elif isinstance(mod, LayerNorm):
            flax = {"scale": params["weight"], "bias": params["bias"]}
        elif isinstance(mod, RMSNorm):
            flax = {"scale": params["weight"]}
        else:
            raise ValueError(f"to_flax_params has no flax layout for "
                             f"{type(mod).__name__} at {name!r}")
        node = tree
        for part in name.split("."):
            node = node.setdefault(part, {})
        node.update({k: np.ascontiguousarray(v) for k, v in flax.items()})
    return tree
