"""Flax params tree -> torch state_dict, for shared-weight parity.

The two frameworks' random initialisers never agree, so the port is held
against the JAX package on the SAME weights: the JAX params tree (as
numpy arrays — this module never imports flax or jax) goes through
`from_flax_params` into a state_dict for the port's modules. Layouts:

- Embed `embedding` [V, E]          -> `weight` [V, E]
- LayerNorm `scale` / `bias`        -> `weight` / `bias`
- Dense `kernel` [in, out]          -> Linear `weight` [out, in]
- DenseGeneral q/k/v `kernel` [E, H, D] -> `weight` [H*D, E]
- DenseGeneral `out` `kernel` [H, D, E] -> `weight` [E, H*D]
- any `bias` [...]                  -> flattened
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


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
        else:
            raise ValueError(f"unexpected kernel rank {arr.ndim} at {path}")
        name = "weight"
    elif name in ("embedding", "scale"):
        name = "weight"
    elif name == "bias":
        arr = arr.reshape(-1)
    else:
        raise ValueError(f"unknown flax param {'/'.join(path)}")
    return ".".join([*mods, name]), torch.tensor(np.ascontiguousarray(arr))


def from_flax_params(params: Mapping) -> dict:
    """Nested {module: {param: array}} (the flax "params" collection, leaves
    as numpy arrays) -> {dotted torch name: fp32 tensor}."""
    out = {}

    def walk(node, path):
        if isinstance(node, Mapping):
            for key, child in node.items():
                walk(child, path + (str(key),))
        else:
            name, tensor = _convert(path, node)
            out[name] = tensor

    walk(params, ())
    return out
