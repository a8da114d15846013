"""Environment knobs — the readers of `tfde_tpu/knobs.py` that the port
needs (`env_str`, `env_int`, `env_float`, `env_flag`) and the
`TFDE_PREFIX_CACHE` spec reader (`prefix_cache_spec`), copied so that the
port never imports the JAX package. The port reads only `TFDE_*` names
the JAX package registers, each with the meaning it has there; the
registry and its unknown-name warning stay with the JAX package.

`env_str` and `env_int` behave as in JAX (a bad integer warns and yields
the default). `env_float`, `env_flag` and `prefix_cache_spec` raise on a
value they cannot read where the JAX readers warn and fall back: they
choose a serving layout (`TFDE_PAGED_KV`, `TFDE_PREFIX_CACHE`) or a
maintenance threshold (`TFDE_KV_DEFRAG_THRESHOLD`), and a misspelled
value must not serve another layout quietly.

Knobs of the serving layouts, with their JAX defaults:

- ``TFDE_PREFIX_CACHE``: off (default), on (the default byte budget), or
  an integer byte budget;
- ``TFDE_PAGED_KV``: paged KV in every ContinuousBatcher (default off);
- ``TFDE_KV_BLOCK``: block size in tokens of the trie and the pool (16);
- ``TFDE_PAGED_PREFILL_CHUNK``: the paged prefill's chunk width (64);
- ``TFDE_KV_DEFRAG_THRESHOLD``: the pool fragmentation above which an
  admission stall defragments the pool (0.5; 0 disables).
"""

from __future__ import annotations

import os
import threading
import warnings
from typing import Any, Optional

_warn_lock = threading.Lock()
_warned: set = set()


def _warn_once(name: str, raw: str, why: str, fallback: Any) -> None:
    key = (name, raw, why)
    with _warn_lock:
        if key in _warned:
            return
        _warned.add(key)
    warnings.warn(
        f"{name}={raw!r} {why}; falling back to {fallback!r}",
        stacklevel=3,
    )


def env_str(name: str, default: Optional[str] = None) -> Optional[str]:
    """Free-form string knob (paths, URLs). Empty string counts as unset."""
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    return raw


def env_int(name: str, default: Optional[int] = None) -> Optional[int]:
    """Integer knob; a non-integer value warns once and yields `default`."""
    raw = os.environ.get(name)
    if raw is None or raw.strip() == "":
        return default
    try:
        return int(raw)
    except ValueError:
        _warn_once(name, raw, "is not an integer", default)
        return default


def env_float(name: str, default: Optional[float] = None) -> Optional[float]:
    """Float knob; a non-numeric value raises ValueError."""
    raw = os.environ.get(name)
    if raw is None or raw.strip() == "":
        return default
    try:
        return float(raw)
    except ValueError:
        raise ValueError(f"{name}={raw!r} is not a number") from None


_TRUTHY = ("1", "true", "yes", "on")
_FALSY = ("", "0", "false", "no", "off")


def env_flag(name: str, default: bool = False) -> bool:
    """Boolean knob (the JAX spellings: 1/true/yes/on, 0/false/no/off or
    empty); any other spelling raises ValueError."""
    raw = os.environ.get(name)
    if raw is None:
        return default
    v = raw.strip().lower()
    if v in _TRUTHY:
        return True
    if v in _FALSY:
        return False
    raise ValueError(f"{name}={raw!r} is not an on/off spelling "
                     f"({'/'.join(_TRUTHY)} or {'/'.join(_FALSY[1:])})")


def prefix_cache_spec(name: str = "TFDE_PREFIX_CACHE"):
    """The prefix-cache spec from the environment: None (off: unset,
    empty, off/0/false/no), True (on/1/true/yes: the default budget) or
    an int byte budget; anything else raises ValueError."""
    raw = os.environ.get(name, "off")
    v = raw.strip().lower()
    if v in _FALSY:
        return None
    if v in _TRUTHY:
        return True
    try:
        return int(v)
    except ValueError:
        raise ValueError(f"{name}={raw!r} is not a recognized value "
                         f"(off/on/<int byte budget>)") from None
