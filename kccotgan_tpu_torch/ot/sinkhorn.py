"""Log-domain Sinkhorn and the mixed causal-Sinkhorn divergence in PyTorch.

Counterpart of ``kccotgan_tpu/ot/sinkhorn.py``.  ``sinkhorn_from_cost``
runs by default the plain loop of L fixed dual updates in the reference
order, differentiated by autograd through every iteration: the
counterpart of ``solver='scan'`` and the oracle of the Sinkhorn kernels
(``cuda_sinkhorn.py``).  Off the training path it also has the JAX
package's two other modes, in plain PyTorch (neither reaches a kernel
there):

* the early stop (``lmin``): a host loop on a detached cost that stops
  once ``sum |u - u_prev| < threshold`` after at least ``lmin`` updates,
  its gradient the implicit-function-theorem VJP at the duals it stops
  at (``ImplicitCost``: one ``[2B, 2B]`` solve with a 1e-6 ridge);
* ``grad='implicit'``: the same VJP at the duals of the L fixed updates.

``compute_sinkhorn`` builds the causal cost (with ``bi_causal`` both
Lagrangians), ``benchmark_sinkhorn`` solves the plain cost with the early
stop, and ``compute_sinkhorn_loss`` is the divergence ``2 W(x, y) -
W(x, x) - W(y, y)`` with the solver dispatch (the unrolled gradient on
every solver):

* ``'scan'``: the plain loop, on any device (the reference path);
* ``'auto'`` / ``'pallas'``: ``cuda_sinkhorn.mixed_sinkhorn``, which
  launches the kernels for CUDA tensors and runs their plain version for
  CPU tensors.
"""

from __future__ import annotations

import torch

from .cost import bi_causal_modified_cost, cost_xy, modified_cost
from .cuda_sinkhorn import _dual_step, _log_mu, mixed_sinkhorn, sinkhorn_fwd_reference

__all__ = [
    "benchmark_sinkhorn",
    "compute_sinkhorn",
    "compute_sinkhorn_loss",
    "flatten_video",
    "sinkhorn_from_cost",
]

# The early stop's default threshold on sum |u - u_prev| (the JAX
# package's ``_STOP_THRESHOLD``).
_STOP_THRESHOLD = 1e-2


def _plan(c, u, v, epsilon):
    return torch.exp((-c + u + v) / epsilon)


class ImplicitCost(torch.autograd.Function):
    """``<pi, C>`` of ``c [B, B]`` at the duals ``u [B, 1]``, ``v [1, B]``,
    differentiated in ``c`` alone by the implicit function theorem at the
    dual fixed point (the JAX package's ``_implicit_bwd``):

      J^T = [[I, P/nu], [(P/mu)^T, I]],  J^T lam = -(1/eps) [P C 1, (P C)^T 1]
      grad_C = pi (1 - C/eps) - (lam1_i + lam2_j) pi_ij / m_ij

    J is singular along the gauge ``(u + t, v - t)``; the system is
    consistent and solved with a 1e-6 ridge."""

    @staticmethod
    def forward(ctx, c, u, v, epsilon):
        ctx.save_for_backward(c, u, v)
        ctx.epsilon = epsilon
        return (_plan(c, u, v, epsilon) * c).sum()

    @staticmethod
    def backward(ctx, g):
        c, u, v = ctx.saved_tensors
        eps, n = ctx.epsilon, c.shape[0]
        pi = _plan(c, u, v, eps)
        mu = torch.full((n,), 1.0 / n, dtype=c.dtype, device=c.device)
        a = pi / mu[:, None]  # P/mu: rows sum to ~1 at convergence
        b = pi / mu[None, :]  # P/nu
        eye = torch.eye(n, dtype=c.dtype, device=c.device)
        jac_t = torch.cat([torch.cat([eye, b], 1), torch.cat([a.T, eye], 1)])
        rhs = -torch.cat([(pi * c).sum(1) / eps, (pi * c).sum(0) / eps])
        lam = torch.linalg.solve(jac_t + 1e-6 * torch.eye(2 * n, dtype=c.dtype, device=c.device), rhs)
        direct = pi * (1.0 - c / eps)
        dual = lam[:n, None] * a + lam[None, n:] * b
        return g * (direct - dual), None, None, None


def _early_stop_duals(c, epsilon, num_iters, lmin, threshold):
    """The duals after dual updates of ``c`` until ``sum |u - u_prev| <
    threshold`` with at least ``lmin`` of them, or ``num_iters``."""
    log_mu = _log_mu(c.shape[-1], c.device)
    u, v = c.new_zeros(c.shape[0], 1), c.new_zeros(1, c.shape[0])
    err, it = torch.tensor(float("inf")), 0
    while it < num_iters and (bool(err >= threshold) or it < lmin):
        u_prev = u
        u, v = _dual_step(c, u, v, log_mu, epsilon)
        err = (u - u_prev).abs().sum()
        it += 1
    return u, v


def sinkhorn_from_cost(c, *, epsilon: float = 1.0, num_iters: int = 100, lmin: int | None = None,
                       threshold: float = _STOP_THRESHOLD, grad: str = "unrolled"):
    """Entropic OT cost ``<pi, C>`` with uniform marginals.

    ``lmin=None`` (the trainer's mode): exactly ``num_iters`` dual updates
    of ``c [..., B, B]``; ``grad='unrolled'`` differentiates through all
    of them by autograd, ``grad='implicit'`` (``c [B, B]``) through
    ``ImplicitCost`` at the final duals.  ``lmin`` set: the early stop on
    a detached ``c [B, B]``, differentiated through ``ImplicitCost``
    (``grad`` is not read)."""
    if lmin is not None:
        with torch.no_grad():
            u, v = _early_stop_duals(c.detach(), epsilon, num_iters, lmin, threshold)
        return ImplicitCost.apply(c, u, v, epsilon)
    if grad == "implicit":
        with torch.no_grad():
            _, uh, vh = sinkhorn_fwd_reference(c.detach(), epsilon, num_iters)
        return ImplicitCost.apply(c, uh[-1][:, None], vh[-1][None, :], epsilon)
    if grad != "unrolled":
        raise ValueError(f"unknown grad mode: {grad!r}")
    return sinkhorn_fwd_reference(c, epsilon, num_iters)[0]


def compute_sinkhorn(x, y, hy, mx, scaling_coef, hx=None, my=None, *, epsilon=1.0, num_iters=100,
                     bi_causal=False, cost_method="gram", grad="unrolled"):
    """Sinkhorn cost on the causally modified cost; with ``bi_causal``
    the cost also carries ``h(x).dM(y)`` (``hx``, ``my``)."""
    if bi_causal:
        c = bi_causal_modified_cost(x, y, hy, mx, hx, my, scaling_coef, cost_method=cost_method)
    else:
        c = modified_cost(x, y, hy, mx, scaling_coef, cost_method=cost_method)
    return sinkhorn_from_cost(c, epsilon=epsilon, num_iters=num_iters, grad=grad)


def benchmark_sinkhorn(x, y, scaling_coef, *, epsilon=1.0, num_iters=10, lmin=10, cost_method="gram"):
    """Plain-cost Sinkhorn evaluation with the early stop."""
    c = cost_xy(x, y, scaling_coef, method=cost_method)
    return sinkhorn_from_cost(c, epsilon=epsilon, num_iters=num_iters, lmin=lmin)


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
