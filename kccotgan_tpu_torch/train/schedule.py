"""Learning-rate schedule: linear warmup into staircase exponential decay.

Counterpart of ``kccotgan_tpu/train/schedule.py``: ``lr0 * step / warmup``
below ``warmup_steps``, then ``lr0 * rate ** floor((step - warmup) /
decay_steps)``, in f32 as the JAX package computes it.  ``step`` is the
Keras iteration, which ``KerasAdam.keras_iter`` computes from a group's
update count.
"""

from __future__ import annotations

import torch

__all__ = ["warmup_staircase_exponential_decay"]


def warmup_staircase_exponential_decay(
    lr0: float,
    warmup_steps: int,
    decay_steps: int,
    decay_rate: float,
):
    """Returns ``schedule(step) -> lr``, a 0-d f32 tensor."""

    def schedule(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = lr0 * step / max(warmup_steps, 1)
        t = torch.clamp_min(step - warmup_steps, 0.0)
        decayed = lr0 * torch.pow(torch.tensor(decay_rate, dtype=torch.float32), torch.floor(t / decay_steps))
        return torch.where(step < warmup_steps, warm, decayed)

    return schedule
