"""Causal optimal-transport cost matrices in PyTorch.

Counterpart of ``kccotgan_tpu/ot/cost.py``.  ``cost_xy`` is the pairwise
squared-L2 cost between two batches of time series, summed over features
and time and scaled; its Gram form is one ``[B, T*F] @ [T*F, B]`` product
(a plain large product, left to ``torch.matmul``).  ``causal_penalty``
is the causality Lagrangian ``C[a, b] = <h_a[:-1], dM_b>``, one product
too.
"""

from __future__ import annotations

import torch

__all__ = ["bi_causal_modified_cost", "causal_penalty", "cost_xy", "modified_cost"]


def cost_xy(x, y, scaling_coef, *, method: str = "gram"):
    """``C[i, j] = scaling * sum_{t,f} (x_i - y_j)^2`` for ``x [B, T, F]``
    and ``y [B', T, F]``: ``'gram'`` as ``|x|^2 + |y|^2 - 2 x.y`` clamped
    at 0, ``'exact'`` in the reference's broadcast-subtract order."""
    if method == "exact":
        diff = x[:, None] - y[None, :]
        return (diff * diff).sum(-1).sum(-1) * scaling_coef
    if method != "gram":
        raise ValueError(f"unknown cost method: {method!r}")
    xf = x.reshape(x.shape[0], -1)
    yf = y.reshape(y.shape[0], -1)
    x_sq = (xf * xf).sum(-1)
    y_sq = (yf * yf).sum(-1)
    sq = x_sq[:, None] + y_sq[None, :] - 2.0 * (xf @ yf.T)
    # torch.maximum, as jnp.maximum, sends half the gradient each way at a
    # tie (clamp_min would send all of it to sq).
    return torch.maximum(sq, torch.zeros_like(sq)) * scaling_coef


def causal_penalty(h, m, scaling_coef):
    """``[B, B']`` penalty: rows follow ``h [B, T, J]``, columns follow
    ``m [B', T, J]``."""
    dm = m[:, 1:] - m[:, :-1]
    ht = h[:, :-1]
    return (ht.reshape(ht.shape[0], -1) @ dm.reshape(dm.shape[0], -1).T) * scaling_coef


def modified_cost(x, y, h, m, scaling_coef, *, cost_method: str = "gram"):
    """Squared-L2 cost plus the causal Lagrangian."""
    return cost_xy(x, y, scaling_coef, method=cost_method) + causal_penalty(h, m, scaling_coef)


def bi_causal_modified_cost(x, y, hy, mx, hx, my, scaling_coef, *, cost_method: str = "gram"):
    """Both ``h(y).dM(x)`` and ``h(x).dM(y)`` terms, rows following
    ``hy`` and ``hx`` alike, as the JAX package adds them."""
    c = cost_xy(x, y, scaling_coef, method=cost_method)
    c = c + causal_penalty(hy, mx, scaling_coef)
    return c + causal_penalty(hx, my, scaling_coef)
