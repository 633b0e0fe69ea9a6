"""Fused Sinkhorn: the Hopper kernels' wrappers and their plain versions.

Counterpart of ``kccotgan_tpu/ot/pallas_sinkhorn.py``.
``sinkhorn_batch(c [K, B, B], eps, L) -> [K]`` solves K independent
problems (uniform marginals 1/B, exactly L dual updates in the reference
order) as a ``torch.autograd.Function``: its forward is ``sinkhorn_fwd``,
which records the post-update ``(u, v)`` history ``[L, K, B]``, and its
backward is ``sinkhorn_bwd``, the hand-derived adjoint of the unrolled
iteration (``_bwd`` there), which equals autograd through the plain loop.

Dispatch: CPU tensors run the plain versions (``sinkhorn_fwd_reference``,
``sinkhorn_bwd_reference``); CUDA tensors of any B launch
``csrc/sinkhorn_fwd.cu`` and ``csrc/sinkhorn_bwd.cu``, one launch for all
K problems, counted in ``sinkhorn_fwd.launches`` /
``sinkhorn_bwd.launches`` (or raise).  The kernels pick their path by B
(``csrc/sinkhorn_common.cuh``): up to 64 a problem lives in the
registers of one block (16 lanes a row), past that in a thread-block
cluster, whose backward passes b_bar and a_bar between its blocks
through a [K, B, B] scratch the wrapper allocates
(``kccot_sinkhorn_bwd_scratch``).
"""

from __future__ import annotations

import functools

import torch

from .._build import load_library
from .cost import modified_cost

__all__ = [
    "mixed_sinkhorn",
    "sinkhorn_batch",
    "sinkhorn_bwd",
    "sinkhorn_bwd_reference",
    "sinkhorn_fwd",
    "sinkhorn_fwd_reference",
]


def _dual_step(c, u, v, log_mu, eps):
    """One dual update of ``c [..., B, B]``, ``u [..., B, 1]``,
    ``v [..., 1, B]`` in the reference order: u first, then v with the
    new u."""
    a = (-c + u + v) / eps
    u = eps * (log_mu - torch.logsumexp(a, dim=-1, keepdim=True)) + u
    b = (-c + u + v) / eps
    v = eps * (log_mu - torch.logsumexp(b, dim=-2, keepdim=True)) + v
    return u, v


@functools.lru_cache(maxsize=16)
def _log_mu(n: int, device: torch.device) -> torch.Tensor:
    """log(1/B) rounded as the JAX package rounds it, f32 log of f32 B,
    made once a (B, device): a captured CUDA graph copies nothing from the
    host."""
    return -torch.log(torch.tensor(float(n), dtype=torch.float32)).to(device)


def sinkhorn_fwd_reference(c, eps: float, num_iters: int):
    """Plain forward of ``c [..., B, B]``, differentiable by autograd:
    ``(cost [...], uhist [L, ..., B], vhist [L, ..., B])``."""
    log_mu = _log_mu(c.shape[-1], c.device)
    u = c.new_zeros(c.shape[:-1] + (1,))
    v = c.new_zeros(c.shape[:-2] + (1, c.shape[-1]))
    us, vs = [], []
    for _ in range(num_iters):
        u, v = _dual_step(c, u, v, log_mu, eps)
        us.append(u[..., 0])
        vs.append(v[..., 0, :])
    cost = (torch.exp((-c + u + v) / eps) * c).sum((-2, -1))
    return cost, torch.stack(us), torch.stack(vs)


def sinkhorn_bwd_reference(c, uhist, vhist, g, eps: float):
    """Plain backward, line by line the JAX package's ``_bwd``:
    ``c_bar [K, B, B]`` from the cotangent ``g [K]`` of the costs."""
    k, n, _ = c.shape
    g = g.reshape(k, 1, 1)
    zeros = uhist.new_zeros(1, k, n)
    u_prev = torch.cat([zeros, uhist[:-1]])
    v_prev = torch.cat([zeros, vhist[:-1]])

    u_l = uhist[-1][:, :, None]
    v_l = vhist[-1][:, None, :]
    pi = torch.exp((-c + u_l + v_l) / eps)
    c_bar = g * pi
    m_bar = g * pi * c
    c_bar = c_bar - m_bar / eps
    u_bar = m_bar.sum(2, keepdim=True) / eps
    v_bar = m_bar.sum(1, keepdim=True) / eps
    for i in reversed(range(uhist.shape[0])):
        u_i = u_prev[i][:, :, None]
        v_i = v_prev[i][:, None, :]
        u_ip1 = uhist[i][:, :, None]
        # v-update adjoint: v_{i+1} = eps (log_nu - s_i) + v_i
        s_bar = -eps * v_bar
        soft_col = torch.softmax((-c + u_ip1 + v_i) / eps, dim=1)
        b_bar = soft_col * s_bar
        c_bar = c_bar - b_bar / eps
        u_ip1_bar = b_bar.sum(2, keepdim=True) / eps
        v_i_bar = v_bar + b_bar.sum(1, keepdim=True) / eps
        u_bar = u_bar + u_ip1_bar
        # u-update adjoint: u_{i+1} = eps (log_mu - r_i) + u_i
        r_bar = -eps * u_bar
        soft_row = torch.softmax((-c + u_i + v_i) / eps, dim=2)
        a_bar = soft_row * r_bar
        c_bar = c_bar - a_bar / eps
        u_bar = u_bar + a_bar.sum(2, keepdim=True) / eps
        v_bar = v_i_bar + a_bar.sum(1, keepdim=True) / eps
    return c_bar


def _check(name, t, shape, device):
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"sinkhorn: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.dtype != torch.float32:
        raise TypeError(f"sinkhorn: {name} is {t.dtype}, expected torch.float32")
    if t.device != device:
        raise ValueError(f"sinkhorn: {name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"sinkhorn: {name} must be contiguous")


def _raise_on(lib, err, name):
    if err:
        raise RuntimeError(f"{name} launch failed: {lib.kccot_error_string(err).decode()}")


def _single_device(name, *tensors):
    devices = {t.device.type for t in tensors}
    if devices not in ({"cpu"}, {"cuda"}):
        raise ValueError(f"{name}: inputs on devices {sorted(devices)}")
    return devices.pop()


def sinkhorn_fwd(c, eps: float, num_iters: int):
    """Forward of K problems: ``(cost [K], uhist [L, K, B], vhist [L, K, B])``.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    once, counted in ``sinkhorn_fwd.launches``.
    """
    if _single_device("sinkhorn_fwd", c) == "cpu":
        return sinkhorn_fwd_reference(c, eps, num_iters)
    if c.dim() != 3 or c.shape[1] != c.shape[2]:
        raise ValueError(f"sinkhorn_fwd: c must be [K, B, B], got {tuple(c.shape)}")
    k, b, _ = c.shape
    _check("c", c, (k, b, b), c.device)
    lib = load_library()
    cost = torch.empty(k, dtype=torch.float32, device=c.device)
    uhist = torch.empty(num_iters, k, b, dtype=torch.float32, device=c.device)
    vhist = torch.empty_like(uhist)
    err = lib.kccot_sinkhorn_fwd(
        c.data_ptr(), cost.data_ptr(), uhist.data_ptr(), vhist.data_ptr(),
        k, b, num_iters, float(eps), torch.cuda.current_stream(c.device).cuda_stream,
    )
    _raise_on(lib, err, "sinkhorn_fwd")
    sinkhorn_fwd.launches += 1
    return cost, uhist, vhist


def sinkhorn_bwd(c, uhist, vhist, g, eps: float):
    """Backward of K problems: ``c_bar [K, B, B]``.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    once, counted in ``sinkhorn_bwd.launches``.
    """
    if _single_device("sinkhorn_bwd", c, uhist, vhist, g) == "cpu":
        return sinkhorn_bwd_reference(c, uhist, vhist, g, eps)
    if c.dim() != 3 or c.shape[1] != c.shape[2]:
        raise ValueError(f"sinkhorn_bwd: c must be [K, B, B], got {tuple(c.shape)}")
    k, b, _ = c.shape
    num_iters = uhist.shape[0]
    for name, t, shape in (
        ("c", c, (k, b, b)), ("uhist", uhist, (num_iters, k, b)),
        ("vhist", vhist, (num_iters, k, b)), ("g", g, (k,)),
    ):
        _check(name, t, shape, c.device)
    lib = load_library()
    scratch = lib.kccot_sinkhorn_bwd_scratch(k, b)
    bm = torch.empty(scratch, dtype=torch.float32, device=c.device) if scratch else None
    c_bar = torch.empty_like(c)
    err = lib.kccot_sinkhorn_bwd(
        c.data_ptr(), uhist.data_ptr(), vhist.data_ptr(), g.data_ptr(), c_bar.data_ptr(),
        None if bm is None else bm.data_ptr(), k, b, num_iters, float(eps),
        torch.cuda.current_stream(c.device).cuda_stream,
    )
    _raise_on(lib, err, "sinkhorn_bwd")
    sinkhorn_bwd.launches += 1
    return c_bar


sinkhorn_fwd.launches = 0
sinkhorn_bwd.launches = 0


class _SinkhornBatch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, c, eps, num_iters):
        cost, uhist, vhist = sinkhorn_fwd(c, eps, num_iters)
        ctx.save_for_backward(c, uhist, vhist)
        ctx.eps = eps
        return cost

    @staticmethod
    def backward(ctx, g):
        c, uhist, vhist = ctx.saved_tensors
        return sinkhorn_bwd(c, uhist, vhist, g.contiguous(), ctx.eps), None, None


def sinkhorn_batch(c, eps: float = 1.0, num_iters: int = 100):
    """Costs ``[K]`` of K problems ``c [K, B, B]``, differentiable in ``c``."""
    return _SinkhornBatch.apply(c.contiguous(), float(eps), int(num_iters))


def mixed_sinkhorn(f_real, f_fake, h_fake, m_real, h_real, m_fake, scaling_coef, *,
                   epsilon: float = 1.0, num_iters: int = 100, cost_method: str = "gram"):
    """``2 W(x, y) - W(x, x) - W(y, y)`` with the three causally modified
    costs (``modified_cost``, built by ``cost_method``) solved together in
    one ``sinkhorn_batch``."""
    kw = dict(cost_method=cost_method)
    c_xy = modified_cost(f_real, f_fake, h_fake, m_real, scaling_coef, **kw)
    c_xx = modified_cost(f_real, f_real, h_real, m_real, scaling_coef, **kw)
    c_yy = modified_cost(f_fake, f_fake, h_fake, m_fake, scaling_coef, **kw)
    costs = sinkhorn_batch(torch.stack([c_xy, c_xx, c_yy]), epsilon, num_iters)
    return 2.0 * costs[0] - costs[1] - costs[2]
