"""The PyTorch port's causal-OT costs, pM and Sinkhorn vs the JAX package.

Inputs are made with numpy from a seed and handed to both.  Tolerances:

* costs, penalties and pM (f32): rtol 1e-6 / atol 1e-6, summation order
  of the Gram products and reductions only;
* the plain Sinkhorn loop vs JAX's scan: forward rtol 1e-5, gradient
  rtol 1e-4 / atol 1e-6, and the port's fused path (plain forward and the
  port of ``_bwd``) vs ``sinkhorn_pallas_batch`` in Pallas interpret mode
  at the same tolerances: the JAX package's own for its kernel against
  its scan (``tests/test_pallas_sinkhorn.py``), since L exp / log passes
  in another summation order move the duals by a few ulp;
* the dual histories at rtol 1e-5 / atol 1e-5 (duals of order 1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kccotgan_tpu import ot as jot
from kccotgan_tpu.ot import pallas_sinkhorn as jps
from kccotgan_tpu_torch import ot
from kccotgan_tpu_torch.ot import cuda_sinkhorn as cs

torch.set_num_threads(1)

B, T, F, J = 5, 4, 7, 3
SCALING = 1.0 / 15.0
L = 20


def _inputs(seed, b=B):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, T, F)).astype(np.float32) for _ in range(2)] + [
        rng.normal(size=(b, T, J)).astype(np.float32) for _ in range(4)
    ]


def _costs(seed, k=3, b=B):
    rng = np.random.default_rng(seed)
    return (np.abs(rng.normal(size=(k, b, b))) + 0.1).astype(np.float32)


def _t(*arrays):
    return [torch.tensor(a) for a in arrays]


def _close(got, want, rtol, atol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("method", ["gram", "exact"])
def test_cost_xy_matches_jax(method):
    x, y, *_ = _inputs(0)
    want = jot.cost_xy(x, y, SCALING, method=method)
    _close(ot.cost_xy(*_t(x, y), SCALING, method=method), want, 1e-6, 1e-6)
    # self-cost: the diagonal is clamped at 0 in the Gram form
    _close(ot.cost_xy(*_t(x, x), SCALING, method=method), jot.cost_xy(x, x, SCALING, method=method), 1e-6, 1e-5)


def test_cost_xy_gradient_matches_jax():
    x, y, *_ = _inputs(1)
    w = np.random.default_rng(2).normal(size=(B, B)).astype(np.float32)
    gx, gy = jax.grad(lambda a, b: jnp.sum(jot.cost_xy(a, b, SCALING) * w), argnums=(0, 1))(x, y)
    xt, yt = (torch.tensor(a, requires_grad=True) for a in (x, y))
    (ot.cost_xy(xt, yt, SCALING) * torch.tensor(w)).sum().backward()
    _close(xt.grad, gx, 1e-5, 1e-6)
    _close(yt.grad, gy, 1e-5, 1e-6)


def test_cost_method_rejects_unknown():
    x, y, *_ = _t(*_inputs(0))
    with pytest.raises(ValueError, match="cost method"):
        ot.cost_xy(x, y, SCALING, method="nope")


def test_penalties_match_jax():
    x, y, h, m, hx, my = _inputs(3)
    _close(ot.causal_penalty(*_t(h, m), SCALING), jot.causal_penalty(h, m, SCALING), 1e-6, 1e-6)
    _close(ot.modified_cost(*_t(x, y, h, m), SCALING), jot.modified_cost(x, y, h, m, SCALING), 1e-6, 1e-6)
    _close(
        ot.bi_causal_modified_cost(*_t(x, y, h, m, hx, my), SCALING),
        jot.bi_causal_modified_cost(x, y, h, m, hx, my, SCALING), 1e-6, 1e-6,
    )


def test_martingale_matches_jax():
    m = _inputs(4)[3]
    _close(ot.delta_m(torch.tensor(m)), jot.delta_m(m), 0, 0)
    want = jot.martingale_regularization(m, 1.0, SCALING)
    mt = torch.tensor(m, requires_grad=True)
    got = ot.martingale_regularization(mt, 1.0, SCALING)
    _close(got, want, 1e-6, 1e-6)
    got.backward()
    _close(mt.grad, jax.grad(lambda a: jot.martingale_regularization(a, 1.0, SCALING))(m), 1e-5, 1e-6)


def test_sinkhorn_from_cost_matches_jax_scan():
    c = _costs(5)[0]
    want = jot.sinkhorn_from_cost(c, epsilon=0.7, num_iters=L)
    ct = torch.tensor(c, requires_grad=True)
    got = ot.sinkhorn_from_cost(ct, epsilon=0.7, num_iters=L)
    _close(got, want, 1e-5, 1e-6)
    got.backward()
    _close(ct.grad, jax.grad(lambda a: jot.sinkhorn_from_cost(a, epsilon=0.7, num_iters=L))(c), 1e-4, 1e-6)


@pytest.fixture(scope="module")
def pallas_reference():
    """``sinkhorn_pallas_batch`` (Pallas interpret mode on the CPU): the
    costs, the dual histories and the gradient under a fixed cotangent."""
    c = _costs(6)
    w = np.array([2.0, -1.0, -1.0], np.float32)
    costs, uhist, vhist = jps._forward(jnp.asarray(c), 0.7, L)
    grad = jax.grad(lambda a: jnp.sum(jps.sinkhorn_pallas_batch(a, 0.7, L) * w))(jnp.asarray(c))
    return c, w, *(np.asarray(a) for a in (costs, uhist, vhist, grad))


def test_fused_forward_matches_pallas(pallas_reference):
    c, _, costs, uhist, vhist, _ = pallas_reference
    before = cs.sinkhorn_fwd.launches
    got, uh, vh = cs.sinkhorn_fwd(torch.tensor(c), 0.7, L)
    assert cs.sinkhorn_fwd.launches == before  # CPU tensors: the plain version
    _close(got, costs, 1e-5, 1e-6)
    _close(uh, uhist, 1e-5, 1e-5)
    _close(vh, vhist, 1e-5, 1e-5)


def test_fused_backward_matches_pallas_and_autograd(pallas_reference):
    c, w, _, uhist, vhist, grad = pallas_reference
    ct = torch.tensor(c, requires_grad=True)
    (cs.sinkhorn_batch(ct, 0.7, L) * torch.tensor(w)).sum().backward()
    _close(ct.grad, grad, 1e-4, 1e-6)
    # the port of _bwd on JAX's own history, and autograd through the loop
    _close(cs.sinkhorn_bwd_reference(*_t(c, uhist, vhist, w), 0.7), grad, 1e-4, 1e-6)
    c2 = torch.tensor(c, requires_grad=True)
    (ot.sinkhorn_from_cost(c2, epsilon=0.7, num_iters=L) * torch.tensor(w)).sum().backward()
    _close(ct.grad, c2.grad.numpy(), 1e-4, 1e-6)


@pytest.mark.parametrize("solver", ["scan", "auto"])
def test_compute_sinkhorn_loss_matches_jax(solver):
    x, y, hf, mr, hr, mf = _inputs(7)
    want = jot.compute_sinkhorn_loss(x, y, SCALING, hf, mr, hr, mf, video=False, num_iters=L, solver="scan")
    args = [torch.tensor(a, requires_grad=True) for a in (x, y, hf, mr, hr, mf)]
    got = ot.compute_sinkhorn_loss(
        args[0], args[1], SCALING, *args[2:], video=False, num_iters=L, solver=solver
    )
    _close(got, want, 1e-5, 1e-5)
    got.backward()
    grads = jax.grad(
        lambda *a: jot.compute_sinkhorn_loss(a[0], a[1], SCALING, *a[2:], video=False, num_iters=L, solver="scan"),
        argnums=tuple(range(6)),
    )(x, y, hf, mr, hr, mf)
    for a, g in zip(args, grads):
        _close(a.grad, g, 1e-4, 1e-5)


def test_fused_path_honours_exact_costs():
    """``cost_method='exact'`` reaches the fused solver: with features at a
    large common offset (300 + N(0, 1)) the Gram form loses digits to
    cancellation, so its loss sits more than 100x the tolerance from the
    exact one; the port's ``'auto'`` (the fused path) on exact costs gives
    JAX's off-TPU ``'auto'`` (the scan) on exact costs, loss and
    gradients."""
    rng = np.random.default_rng(10)
    x, y = [(300.0 + rng.normal(size=(B, T, F))).astype(np.float32) for _ in range(2)]
    h = [rng.normal(size=(B, T, J)).astype(np.float32) for _ in range(4)]
    kw = dict(video=False, num_iters=L, solver="auto")

    def jax_loss(*a):
        return jot.compute_sinkhorn_loss(a[0], a[1], SCALING, *a[2:], cost_method="exact", **kw)

    want = jax_loss(x, y, *h)
    args = [torch.tensor(a, requires_grad=True) for a in (x, y, *h)]
    got = ot.compute_sinkhorn_loss(args[0], args[1], SCALING, *args[2:], cost_method="exact", **kw)
    gram = ot.compute_sinkhorn_loss(*_t(x, y), SCALING, *_t(*h), cost_method="gram", **kw)
    tol = 1e-5 + 1e-5 * abs(float(want))
    assert abs(float(gram) - float(want)) > 100 * tol
    _close(got, want, 1e-5, 1e-5)
    got.backward()
    grads = jax.grad(jax_loss, argnums=tuple(range(6)))(x, y, *h)
    for a, g in zip(args, grads):
        _close(a.grad, g, 1e-4, 1e-5)


def test_flatten_video_and_unknown_solver():
    v = np.random.default_rng(8).normal(size=(2, 3, 4, 5, 1)).astype(np.float32)
    _close(ot.flatten_video(torch.tensor(v)), jot.flatten_video(v), 0, 0)
    x = torch.zeros(2, 3, 4)
    with pytest.raises(ValueError, match="solver"):
        ot.compute_sinkhorn_loss(x, x, SCALING, x, x, x, x, video=False, solver="nope")


def test_kernel_wrappers_refuse_mixed_devices():
    c = torch.tensor(_costs(9))
    with pytest.raises(ValueError, match="devices"):
        cs.sinkhorn_bwd(c, torch.zeros(2, 3, B), torch.zeros(2, 3, B, device="meta"), torch.ones(3), 1.0)
