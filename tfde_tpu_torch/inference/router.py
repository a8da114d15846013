"""The primed-request wire format — the part of
`tfde_tpu/inference/router.py` that the prefill/decode role split needs
(`primed_to_json`, `primed_from_json`). The router's HTTP layer is not
ported yet (ROADMAP queue 1 item 5.3).

The format is the JAX package's, so a payload written by either package
loads in the other: the prompt and the first token as JSON ints, and
each K/V plane as {"shape", "dtype", "data": base64 of the raw bytes},
keyed by the JAX cache-collection leaf path (`prefix_cache.leaf_name`:
``decoder/block_<layer>/attn/cached_key`` and so on). The one mapping
between those paths and the port's plane names (`KVCache.planes()`:
`(layer, 'k' | 'v' | 'k_scale' | 'v_scale')`) is `LEAF_OF` below, read
off the JAX `init_cache` trees (dense and int8). The dtype names are
numpy's ("float32", "int8"); bfloat16 travels as its raw 16-bit words
under "bfloat16", the JAX package's `ml_dtypes` name, with no
`ml_dtypes` here. An unknown dtype or leaf path raises.
"""

from __future__ import annotations

import base64
import re

import numpy as np
import torch

#: the port's plane -> the JAX attention module's cache leaf
LEAF_OF = {"k": "cached_key", "v": "cached_value",
           "k_scale": "cached_key_scale", "v_scale": "cached_value_scale"}
_PLANE_OF = {leaf: plane for plane, leaf in LEAF_OF.items()}
_LEAF_PATH = re.compile(r"decoder/block_(\d+)/attn/(\w+)")

#: wire dtype name <-> torch dtype
_DTYPES = {"float32": torch.float32, "float16": torch.float16,
           "bfloat16": torch.bfloat16, "int8": torch.int8}
_WIRE = {t: name for name, t in _DTYPES.items()}


def leaf_name(name: tuple) -> str:
    """The JAX leaf path of the port's plane `(layer, plane)`."""
    layer, plane = name
    if plane not in LEAF_OF:
        raise ValueError(f"unknown K/V plane {plane!r}")
    return f"decoder/block_{int(layer)}/attn/{LEAF_OF[plane]}"


def plane_name(leaf: str) -> tuple:
    """The port's plane `(layer, plane)` of a JAX leaf path."""
    m = _LEAF_PATH.fullmatch(leaf)
    if m is None or m.group(2) not in _PLANE_OF:
        raise ValueError(f"unknown K/V leaf {leaf!r}: expected "
                         f"decoder/block_<layer>/attn/<"
                         f"{'|'.join(_PLANE_OF)}>")
    return int(m.group(1)), _PLANE_OF[m.group(2)]


def _encode(t: torch.Tensor) -> dict:
    if t.dtype not in _WIRE:
        raise ValueError(f"no wire dtype for {t.dtype}")
    t = t.detach().cpu().contiguous()
    # numpy has no bfloat16: its bytes travel as 16-bit words
    raw = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()
    return {"shape": list(t.shape), "dtype": _WIRE[t.dtype],
            "data": base64.b64encode(raw.tobytes()).decode("ascii")}


def _decode(entry: dict) -> torch.Tensor:
    dtype = _DTYPES.get(entry["dtype"])
    if dtype is None:
        raise ValueError(f"unknown wire dtype {entry['dtype']!r}; expected "
                         f"one of {sorted(_DTYPES)}")
    raw = bytearray(base64.b64decode(entry["data"]))
    return torch.frombuffer(raw, dtype=dtype).reshape(entry["shape"])


def primed_to_json(primed) -> dict:
    """PrimedRequest -> JSON-safe dict (K/V as base64 raw bytes)."""
    return {
        "prompt": np.asarray(primed.prompt).tolist(),
        "first_token": int(primed.first_token),
        "max_new_tokens": int(primed.max_new_tokens),
        "kv": {leaf_name(name): _encode(t) for name, t in primed.kv.items()},
    }


def primed_from_json(payload: dict):
    """JSON dict (from either package) -> PrimedRequest with host tensors
    keyed by the port's plane names."""
    from tfde_tpu_torch.inference.server import PrimedRequest

    return PrimedRequest(
        prompt=np.asarray(payload["prompt"], np.int64),
        first_token=int(payload["first_token"]),
        max_new_tokens=int(payload["max_new_tokens"]),
        kv={plane_name(leaf): _decode(e)
            for leaf, e in payload["kv"].items()},
    )
