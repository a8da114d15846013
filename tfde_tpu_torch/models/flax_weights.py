"""Flax params tree -> torch state_dict, for shared-weight parity.

The two frameworks' random initialisers never agree, so the port is held
against the JAX package on the SAME weights: the JAX params tree (as
numpy arrays — this module never imports flax or jax) goes through
`from_flax_params` into a state_dict for the port's modules. Layouts:

- Embed `embedding` [V, E]          -> `weight` [V, E]
- LayerNorm `scale` / `bias`        -> `weight` / `bias`
- Dense `kernel` [in, out]          -> Linear `weight` [out, in]
- Conv `kernel` HWIO [kh, kw, in, out] -> Conv2d `weight` OIHW
- DenseGeneral q/k/v `kernel` [E, H, D] -> `weight` [H*D, E] (k/v
  [E, Kv, D] -> [Kv*D, E] under grouped-query attention)
- DenseGeneral `out` `kernel` [H, D, E] -> `weight` [E, H*D]
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
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

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
