"""Environment knobs — the readers of `tfde_tpu/knobs.py` that the port
needs (`env_str`, `env_int`, `env_float`, `env_flag`), the
`TFDE_PREFIX_CACHE` spec reader (`prefix_cache_spec`) and the readers of
the KV layout and capacity knobs (`kv_quant_spec`, `env_count`), copied
or written so that the port never imports the JAX package. The port reads only `TFDE_*` names
the JAX package registers, each with the meaning it has there; the
registry and its unknown-name warning stay with the JAX package.

`env_str` and `env_int` behave as in JAX (a bad integer warns and yields
the default). `env_float`, `env_flag`, `env_count`, `prefix_cache_spec`
and `kv_quant_spec` raise on a value they cannot read where the JAX
readers warn and fall back: they choose a serving layout
(`TFDE_PAGED_KV`, `TFDE_PREFIX_CACHE`, `TFDE_KV_QUANT`), a maintenance
threshold (`TFDE_KV_DEFRAG_THRESHOLD`), a byte bound
(`TFDE_CAPACITY_*`) or an admission cap (`TFDE_ADMIT_*`), and a
misspelled value must not serve another layout, report another
headroom, or lift a cap, quietly.

Knobs of the serving layouts, with their JAX defaults:

- ``TFDE_PREFIX_CACHE``: off (default), on (the default byte budget), or
  an integer byte budget;
- ``TFDE_PAGED_KV``: paged KV in every ContinuousBatcher (default off);
- ``TFDE_KV_BLOCK``: block size in tokens of the trie and the pool (16);
- ``TFDE_PAGED_PREFILL_CHUNK``: the paged prefill's chunk width (64);
- ``TFDE_KV_DEFRAG_THRESHOLD``: the pool fragmentation above which an
  admission stall defragments the pool (0.5; 0 disables);
- ``TFDE_KV_QUANT``: the KV storage format of every ContinuousBatcher,
  fp (default) or int8 (int8 payload + fp32 scale planes in the slab,
  the pool and the tries).

Knobs of the capacity ledger and the usage meter
(observability/capacity.py), with their JAX defaults:

- ``TFDE_CAPACITY_BUDGET_BYTES``: the KV byte budget the headroom model
  folds against (0: the slab's own free rows);
- ``TFDE_USAGE_LOG``: the per-request usage JSONL: off (default), on
  (``<model_dir>/metrics/usage_<host>.jsonl``) or a path;
- ``TFDE_CAPACITY_USAGE_LOG_BYTES``: the byte bound of one usage log
  (8 MiB).

Knobs of admission control (inference/admission.py), read by every
batcher's default `AdmissionController`; each 0 (the default) is off:

- ``TFDE_ADMIT_MAX_QUEUE``: the most QUEUED requests before `submit()`
  raises `QueueFull` (`env_count`);
- ``TFDE_ADMIT_MAX_QUEUED_TOKENS``: the most queued output tokens
  (`env_count`);
- ``TFDE_ADMIT_TTFT_DEADLINE_MS``: the default TTFT deadline; a request
  still queued past it is shed at dequeue (`env_float`);
- ``TFDE_ADMIT_KV_HEADROOM``: the fewest headroom rows (`kv_stats()`)
  under which `submit()` raises `QueueFull` (`env_count`).
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


def env_count(name: str, default: int = 0) -> int:
    """Non-negative integer knob (a byte count); anything else raises
    ValueError."""
    raw = os.environ.get(name)
    if raw is None or raw.strip() == "":
        return default
    try:
        value = int(raw)
    except ValueError:
        raise ValueError(f"{name}={raw!r} is not an integer") from None
    if value < 0:
        raise ValueError(f"{name}={raw!r} must be >= 0")
    return value


KV_QUANT_CHOICES = ("fp", "int8")


def kv_quant_spec(name: str = "TFDE_KV_QUANT") -> str:
    """The KV storage format from the environment: 'fp' (unset, empty or
    fp) or 'int8', case-insensitive; anything else raises ValueError."""
    raw = os.environ.get(name)
    if raw is None or raw.strip() == "":
        return "fp"
    v = raw.strip().lower()
    if v not in KV_QUANT_CHOICES:
        raise ValueError(f"{name}={raw!r} is not one of {KV_QUANT_CHOICES}")
    return v
