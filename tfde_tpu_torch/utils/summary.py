"""Model parameter summary — counterpart of `tfde_tpu/utils/summary.py`
(`model_summary` :44), the `model.summary()` both reference Estimator
scripts print before training (mnist_keras_distributed.py:117,
tf2_mnist_distributed.py:143).

The JAX package counts a flax module's abstract init; a torch module
already holds its parameters, so the table reads them as they are:
parameters grouped by the first `depth` parts of their names, each
group's count and bytes, the total, and the buffers (BatchNorm's running
statistics, the JAX `batch_stats`) on a line of their own as
non-trainable.
"""

from __future__ import annotations

from typing import Any, Iterable, Optional, Tuple

import torch
from torch import nn


def _count(tensors: Iterable[torch.Tensor]) -> Tuple[int, int]:
    """(element count, bytes) over `tensors`."""
    n = b = 0
    for t in tensors:
        n += t.numel()
        b += t.numel() * t.element_size()
    return n, b


def _fmt_bytes(b: float) -> str:
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if b < 1024 or unit == "TB":
            return f"{b:.1f} {unit}" if unit != "B" else f"{b} B"
        b /= 1024
    return f"{b:.1f} TB"


def model_summary(model: nn.Module, sample_input: Optional[Any] = None,
                  depth: int = 2) -> str:
    """The parameter table of `model`, grouped to `depth` name parts
    (``Conv_0.weight`` is the group ``Conv_0/weight`` at depth 2), as a
    string to print. `sample_input` is taken for the JAX signature and
    not read: the module's parameters exist already."""
    groups: dict = {}
    for name, p in model.named_parameters():
        group = "/".join(name.split(".")[:depth]) or "(root)"
        cn, cb = groups.get(group, (0, 0))
        n, b = _count([p])
        groups[group] = (cn + n, cb + b)
    rows = [(g, *groups[g]) for g in groups]
    w = max([len(r[0]) for r in rows] + [len("module")]) + 2
    cw = max([len(f"{r[1]:,}") for r in rows] + [len("params")]) + 2
    lines = [
        f'Model: "{type(model).__name__}"',
        "=" * (w + cw + 10),
        f"{'module':<{w}}{'params':>{cw}}  {'bytes':>8}",
        "-" * (w + cw + 10),
    ]
    for g, n, b in rows:
        lines.append(f"{g:<{w}}{n:>{cw},}  {_fmt_bytes(b):>8}")
    total_n, total_b = _count(model.parameters())
    lines.append("=" * (w + cw + 10))
    lines.append(f"Total params: {total_n:,} ({_fmt_bytes(total_b)})")
    buf_n, buf_b = _count(model.buffers())
    if buf_n:
        lines.append(f"buffers: {buf_n:,} ({_fmt_bytes(buf_b)}) — "
                     f"non-trainable")
    return "\n".join(lines)
