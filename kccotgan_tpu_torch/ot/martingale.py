"""Scale-invariant martingale regularization (pM) in PyTorch.

Counterpart of ``kccotgan_tpu/ot/martingale.py``: the first difference
of the M-discriminator's output over time, standardized by the
per-feature population std of M over (batch, time);
``pM = reg_lam * scaling * sum_{t,j} |mean_batch N_std|``.
"""

from __future__ import annotations

import torch

__all__ = ["delta_m", "martingale_regularization"]


def delta_m(m):
    """First difference along time (axis 1)."""
    return m[:, 1:] - m[:, :-1]


def martingale_regularization(m, reg_lam, scaling_coef):
    """Scalar pM of ``m [B, T, J]``."""
    n = delta_m(m)
    # population std (ddof 0), as jnp.std; torch's default is unbiased
    std = torch.std(m, dim=(0, 1), correction=0)
    n_std = n / (std + 1e-6)
    sum_m_std = n_std.sum(0) / m.shape[0]
    return reg_lam * (sum_m_std.abs().sum() * scaling_coef)
