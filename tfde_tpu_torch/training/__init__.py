"""Training: train state, steps, optimizers and the Estimator lifecycle —
counterpart of `tfde_tpu/training`."""

from tfde_tpu_torch.training.lifecycle import (  # noqa: F401
    Estimator,
    EvalSpec,
    RunConfig,
    TrainSpec,
    continuous_eval,
    train_and_evaluate,
)
from tfde_tpu_torch.training.step import (  # noqa: F401
    init_state,
    make_eval_step,
    make_train_step,
)
from tfde_tpu_torch.training.train_state import TrainState  # noqa: F401
