"""Optimizer helpers — counterpart of `tfde_tpu/training/optimizers.py`,
with the one optax schedule the training entry point uses.

`adamw(...)` is optax.adamw with the standard decay mask: weight decay
applies to matmul weights and embeddings only — biases and LayerNorm
scales are excluded (the BERT/GPT-2 convention). The JAX package decides
the mask from flax names ('bias', 'scale') and rank; torch names differ
(a flax LayerNorm `scale` is a torch LayerNorm `weight`), so here it is
decided by module type and rank, which gives the same mask under
`models.flax_weights.from_flax_params`'s names.

The arithmetic is optax's: bias-corrected moments, eps outside the square
root, decoupled decay lr * wd * p on the masked parameters, and the lr of
update t (0-based) is schedule(t) — so the first update of a warmup from
0 moves nothing. `torch.optim.AdamW` over two parameter groups computes
exactly that once the lr is set before each step (`TrainState`).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Union

import torch
from torch import nn

Schedule = Callable[[int], float]


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0,
                                 exponent: float = 1.0) -> Schedule:
    """optax.warmup_cosine_decay_schedule: a linear ramp from `init_value`
    to `peak_value` over `warmup_steps`, then a cosine decay to
    `end_value` at `decay_steps` (which counts the warmup) and flat
    after."""
    cosine_steps = decay_steps - warmup_steps
    if cosine_steps <= 0:
        raise ValueError(f"the cosine decay needs decay_steps > warmup_steps, "
                         f"got decay_steps={decay_steps}, warmup_steps="
                         f"{warmup_steps}")
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value

    def schedule(count: int) -> float:
        if count >= warmup_steps:
            c = min(count - warmup_steps, cosine_steps)
            decay = 0.5 * (1.0 + math.cos(math.pi * c / cosine_steps))
            return peak_value * ((1.0 - alpha) * decay ** exponent + alpha)
        if warmup_steps <= 0:
            return init_value
        frac = 1.0 - max(count, 0) / warmup_steps
        return (init_value - peak_value) * frac + peak_value

    return schedule


def decay_mask(model: nn.Module) -> Dict[str, bool]:
    """{parameter name: True where weight decay applies}: not a bias, not
    a LayerNorm parameter, and of rank >= 2."""
    mask = {}
    for mod_name, mod in model.named_modules():
        for name, p in mod.named_parameters(recurse=False):
            full = f"{mod_name}.{name}" if mod_name else name
            mask[full] = (name != "bias" and not isinstance(mod, nn.LayerNorm)
                          and p.dim() >= 2)
    return mask


class AdamW(torch.optim.AdamW):
    """torch AdamW over two groups, the parameters `decay_mask` decays
    (weight decay `weight_decay`) and the rest (none), carrying the
    schedule that `TrainState.apply_gradients` reads the lr of each
    update from."""

    def __init__(self, model: nn.Module, schedule: Schedule,
                 b1: float, b2: float, eps: float, weight_decay: float):
        mask = decay_mask(model)
        params = dict(model.named_parameters())
        groups = [
            {"params": [params[n] for n, on in mask.items() if on],
             "weight_decay": weight_decay},
            {"params": [params[n] for n, on in mask.items() if not on],
             "weight_decay": 0.0},
        ]
        super().__init__([g for g in groups if g["params"]],
                         lr=float(schedule(0)), betas=(b1, b2), eps=eps)
        self.schedule = schedule


def adamw(model: nn.Module, learning_rate: Union[float, Schedule],
          b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 1e-4) -> AdamW:
    """optax.adamw with the decay mask (see the module docstring);
    `learning_rate` is a constant or a schedule of the update count."""
    if callable(learning_rate):
        schedule = learning_rate
    else:
        def schedule(_count: int, lr=float(learning_rate)) -> float:
            return lr
    return AdamW(model, schedule, b1, b2, eps, weight_decay)
