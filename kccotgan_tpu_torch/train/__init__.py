"""Serving and training paths of the PyTorch port."""

from .keras_adam import KerasAdam, KerasAdamState
from .rollout import build_rollout
from .schedule import warmup_staircase_exponential_decay
from .state import TrainState, create_train_state, make_optimizers
from .steps import build_train_step, gan_forward

__all__ = [
    "KerasAdam",
    "KerasAdamState",
    "TrainState",
    "build_rollout",
    "build_train_step",
    "create_train_state",
    "gan_forward",
    "make_optimizers",
    "warmup_staircase_exponential_decay",
]
