"""Environment knobs — the two readers of `tfde_tpu/knobs.py` that the
port needs (`env_str`, `env_int`), copied so that the port never imports
the JAX package. The port reads only `TFDE_*` names the JAX package
registers, each with the meaning it has there; the registry and its
unknown-name warning stay with the JAX package.
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
