"""Train state — counterpart of `tfde_tpu/training/train_state.py`.

The JAX `TrainState` is an immutable pytree {step, params, opt_state}
that `apply_gradients` replaces. Here the parameters live in the model
(fp32 master weights, cast to the compute dtype inside each layer) and
the moments in the torch optimizer, so the state is a small mutable
holder and `apply_gradients` updates it in place.
"""

from __future__ import annotations

from torch import nn

from tfde_tpu_torch.training.optimizers import AdamW, Schedule


class TrainState:
    """`step` (updates applied so far), the model, the optimizer `tx` and
    the lr schedule."""

    def __init__(self, model: nn.Module, tx: AdamW, schedule: Schedule):
        self.step = 0
        self.model = model
        self.tx = tx
        self.schedule = schedule

    def apply_gradients(self) -> "TrainState":
        """One optimizer update from the gradients held in the parameters'
        `.grad`: the lr of update `step` is `schedule(step)` (optax's
        count), then `step` goes up by one and the gradients are
        cleared."""
        lr = float(self.schedule(self.step))
        for group in self.tx.param_groups:
            group["lr"] = lr
        self.tx.step()
        self.tx.zero_grad(set_to_none=True)
        self.step += 1
        return self
