"""Log-domain Sinkhorn and the mixed causal-Sinkhorn divergence in PyTorch.

Counterpart of ``kccotgan_tpu/ot/sinkhorn.py``.  ``sinkhorn_from_cost``
is the plain loop of L fixed dual updates in the reference order,
differentiated by autograd through every iteration: the counterpart of
``solver='scan'`` and the oracle of the Sinkhorn kernels
(``cuda_sinkhorn.py``).  ``compute_sinkhorn_loss`` is the divergence
``2 W(x, y) - W(x, x) - W(y, y)`` with the solver dispatch:

* ``'scan'``: the plain loop, on any device (the reference path);
* ``'auto'`` / ``'pallas'``: ``cuda_sinkhorn.mixed_sinkhorn``, which
  launches the kernels for CUDA tensors and runs their plain version for
  CPU tensors.

Not ported yet (ROADMAP Queue 1): the ``lmin`` early stop and the
``grad='implicit'`` gradient of ``sinkhorn_from_cost``, and
``benchmark_sinkhorn``; none is on the training step's path.
"""

from __future__ import annotations

import torch

from .cost import modified_cost
from .cuda_sinkhorn import mixed_sinkhorn, sinkhorn_fwd_reference

__all__ = ["compute_sinkhorn", "compute_sinkhorn_loss", "flatten_video", "sinkhorn_from_cost"]


def sinkhorn_from_cost(c, *, epsilon: float = 1.0, num_iters: int = 100):
    """Entropic OT cost ``<pi, C>`` of ``c [..., B, B]`` with uniform
    marginals and exactly ``num_iters`` dual updates: the plain loop,
    differentiable by autograd."""
    return sinkhorn_fwd_reference(c, epsilon, num_iters)[0]


def compute_sinkhorn(x, y, hy, mx, scaling_coef, *, epsilon=1.0, num_iters=100, cost_method="gram"):
    """Sinkhorn cost on the causally modified cost."""
    c = modified_cost(x, y, hy, mx, scaling_coef, cost_method=cost_method)
    return sinkhorn_from_cost(c, epsilon=epsilon, num_iters=num_iters)


def flatten_video(frames):
    """``[B, H, T, W, C]`` film-strip video -> ``[B, T, H*W*C]`` series."""
    x = frames.permute(0, 2, 1, 3, 4)
    return x.reshape(x.shape[0], x.shape[1], -1)


def compute_sinkhorn_loss(
    f_real, f_fake, scaling_coef, h_fake, m_real, h_real, m_fake, *,
    video: bool = True, epsilon: float = 1.0, num_iters: int = 100,
    cost_method: str = "gram", solver: str = "auto",
):
    """Mixed causal-Sinkhorn divergence ``2 W(x, y) - W(x, x) - W(y, y)``,
    its costs built by ``cost_method`` on every solver."""
    if video:
        f_real = flatten_video(f_real)
        f_fake = flatten_video(f_fake)
    if solver in ("auto", "pallas"):
        return mixed_sinkhorn(
            f_real, f_fake, h_fake, m_real, h_real, m_fake, scaling_coef,
            epsilon=epsilon, num_iters=num_iters, cost_method=cost_method,
        )
    if solver != "scan":
        raise ValueError(f"unknown sinkhorn solver: {solver!r}")
    kw = dict(epsilon=epsilon, num_iters=num_iters, cost_method=cost_method)
    loss_xy = compute_sinkhorn(f_real, f_fake, h_fake, m_real, scaling_coef, **kw)
    loss_xx = compute_sinkhorn(f_real, f_real, h_real, m_real, scaling_coef, **kw)
    loss_yy = compute_sinkhorn(f_fake, f_fake, h_fake, m_fake, scaling_coef, **kw)
    return 2.0 * loss_xy - loss_xx - loss_yy
