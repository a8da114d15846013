"""Device resolution for the port's entry points.

The JAX package picks its backend from the environment; the port makes the
choice explicit. Every entry point takes a `device` argument and resolves
it here: CUDA by default, the CPU only when the caller asks for it, and an
error — never a quiet CPU fallback — when CUDA is asked for and absent.
Under a process group each rank takes its own card: ``cuda`` without an
index is ``cuda:<rank % local GPU count>``, the card
`runtime.cluster.bootstrap` made current.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.distributed as dist


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """`None` -> this rank's CUDA device; ``"cpu"`` -> the CPU; any CUDA
    spelling -> that device. Raises RuntimeError when CUDA is requested
    (explicitly or by default) and `torch.cuda.is_available()` is false."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(
            f"device must be 'cuda[:N]' or 'cpu', got {str(dev)!r}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU (the port never falls back to it on its own)")
    if dev.index is None:
        index = (dist.get_rank() % torch.cuda.device_count()
                 if dist.is_initialized() else torch.cuda.current_device())
        dev = torch.device("cuda", index)
    return dev
