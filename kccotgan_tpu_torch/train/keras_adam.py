"""Keras-3-exact Adam on dicts of tensors.

Counterpart of ``kccotgan_tpu/train/keras_adam.py``.  The reference
updates its four parameter groups through two shared Keras Adam
instances, two ``apply_gradients`` calls per optimizer per iteration (h
then m; encoder then decoder).  What plain Adam does not match, and this
does:

* the schedule is read at the Keras iteration of the group's n-th update
  (0-based), ``2n + offset`` with ``double_step``, else ``n``;
* the bias-correction powers use ``t = iteration + 1``, folded into the
  step size ``alpha = lr * sqrt(1 - b2^t) / (1 - b1^t)``;
* epsilon is added to the raw ``sqrt(v)``:
  ``p <- p - alpha * m / (sqrt(v) + eps)``.

``update`` returns new tensors and leaves its inputs as they were, so a
state can be stepped twice (the kernel path and its plain reference).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

__all__ = ["KerasAdam", "KerasAdamState"]


@dataclass
class KerasAdamState:
    count: int  # updates made to this parameter group so far
    mu: dict
    nu: dict


class KerasAdam:
    def __init__(
        self,
        learning_rate: Callable | float,
        b1: float = 0.9,
        b2: float = 0.999,
        eps: float = 1e-7,
        *,
        double_step: bool = False,
        offset: int = 0,
    ):
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps = b1, b2, eps
        self.double_step, self.offset = double_step, offset

    def keras_iter(self, count: int) -> int:
        return 2 * count + self.offset if self.double_step else count

    def init(self, params: dict) -> KerasAdamState:
        return KerasAdamState(
            count=0,
            mu={k: torch.zeros_like(v) for k, v in params.items()},
            nu={k: torch.zeros_like(v) for k, v in params.items()},
        )

    def alpha(self, count: int) -> torch.Tensor:
        """The step size of the group's update number ``count``, a 0-d
        float32 CPU tensor computed in float32 on the host."""
        it = self.keras_iter(count)
        lr = self.learning_rate(it) if callable(self.learning_rate) else self.learning_rate
        lr = torch.as_tensor(lr, dtype=torch.float32)
        t = torch.tensor(it + 1, dtype=torch.float32)
        b1p = torch.tensor(self.b1, dtype=torch.float32) ** t
        b2p = torch.tensor(self.b2, dtype=torch.float32) ** t
        return lr * torch.sqrt(1.0 - b2p) / (1.0 - b1p)

    def update(self, grads: dict, state: KerasAdamState, params: dict, alpha: torch.Tensor | None = None):
        """``(new_params, new_state)`` after one update with ``grads``.
        ``alpha``, a 0-d float32 tensor on the parameters' device, stands
        for ``self.alpha(state.count)``: a captured CUDA graph reads the
        step size from device memory, where each replay writes it."""
        if alpha is None:
            alpha = self.alpha(state.count)
        mu, nu, new_params = {}, {}, {}
        for k, p in params.items():
            g = grads[k]
            m = state.mu[k] + (g - state.mu[k]) * (1.0 - self.b1)
            v = state.nu[k] + (torch.square(g) - state.nu[k]) * (1.0 - self.b2)
            new_params[k] = p + (-(m * alpha) / (torch.sqrt(v) + self.eps))
            mu[k], nu[k] = m, v
        return new_params, KerasAdamState(count=state.count + 1, mu=mu, nu=nu)
