"""The CUDA kernels vs their plain PyTorch versions, on the card.

Needs an NVIDIA GPU (and nvcc to build the kernel): every test skips
without one.  Imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports JAX; the ``cuda`` marker
is registered in ``pyproject.toml``.)  The ConvLSTM shapes are
the awkward ones ``chip_smoke.py`` does not reach: frames whose pixel
count is not a multiple of a thread's pixel run, channel counts that are not a
multiple of its 32-channel tile, a rectangular frame, and shared memory
beyond the default 48 KiB; the backward adds B=1 and f=2.  The LSTM
shapes: B=1, U=3 (an odd U, and fewer units than a warp), ragged row
blocks (B=5), and U=64, whose staged recurrent kernel needs more than
48 KiB of shared memory.  The Sinkhorn sizes cover fewer rows than a
warp (2, 6), a ragged second warp column (33) and shared memory beyond
48 KiB (128), at eps 0.7.

Tolerances: ConvLSTM and LSTM forward f32 (TF32 off) at 2e-5 abs,
summation order only; bf16 at 2e-2 abs, one bf16 ulp of the once-rounded
recurrent conv or of y, carried over the steps.  Backward kernels: each
gradient within 1e-5 (f32) or 2e-2 (bf16) of its largest entry, the same
argument, the bf16 one as the CPU tests against JAX's VJP
(``test_torch_lstm.py``, ``test_torch_convlstm_grad.py``).  Sinkhorn (f32): costs at rtol 1e-5 and
c_bar at rtol 1e-4 / atol 1e-6, the JAX package's tolerances for its
fused kernel against the scan (``tests/test_pallas_sinkhorn.py``), and
the histories at 1e-4 abs (the duals of B <= 128 points, of order 1 to
10, after L sums in another order).
"""

import pytest
import torch

from kccotgan_tpu_torch.models.cuda_convlstm import (
    convlstm_bwd,
    convlstm_bwd_reference,
    convlstm_fwd,
    convlstm_fwd_reference,
    convlstm_scan,
    convlstm_scan_reference,
)
from kccotgan_tpu_torch.models.cuda_lstm import lstm_bwd, lstm_bwd_reference, lstm_fwd, lstm_scan_reference
from kccotgan_tpu_torch.ot.cuda_sinkhorn import (
    sinkhorn_batch,
    sinkhorn_bwd,
    sinkhorn_bwd_reference,
    sinkhorn_fwd,
    sinkhorn_fwd_reference,
)

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
GRAD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}  # of each gradient's largest entry


@pytest.fixture
def cuda():
    """The card, with TF32 off in cuDNN for the plain version's convs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    allow_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = allow_tf32


def _inputs(b, t, h, w, f, k, dtype, dev, seed=0):
    g = torch.Generator().manual_seed(seed)
    xconv = torch.randn(b, t, h, w, 4 * f, generator=g).to(dev, dtype)
    h0 = (torch.randn(b, h, w, f, generator=g) * 0.5).to(dev)
    c0 = (torch.randn(b, h, w, f, generator=g) * 0.5).to(dev)
    rk = (torch.randn(k, k, f, 4 * f, generator=g) * (k * k * f) ** -0.5).to(dev)
    bias = (torch.randn(4 * f, generator=g) * 0.1).to(dev)
    return xconv, h0, c0, rk, bias


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "h,w,f,k",
    [(6, 6, 3, 3), (5, 7, 4, 4), (9, 13, 40, 5), (7, 7, 8, 8), (4, 4, 256, 5), (3, 18, 33, 2)],
)
def test_kernel_matches_plain(cuda, h, w, f, k, dtype):
    args = _inputs(2, 3, h, w, f, k, dtype, cuda)
    before = convlstm_fwd.launches
    with torch.no_grad():
        y_k, (h_k, c_k) = convlstm_scan(*args)
        y_p, (h_p, c_p) = convlstm_scan_reference(*args)
    torch.cuda.synchronize()
    assert convlstm_fwd.launches == before + 3
    assert y_k.dtype == dtype and h_k.dtype == c_k.dtype == torch.float32
    for got, want in ((y_k, y_p), (h_k, h_p), (c_k, c_p)):
        torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=TOL[dtype])
    # the caller's carry is read, never written
    torch.testing.assert_close(args[1], _inputs(2, 3, h, w, f, k, dtype, cuda)[1], rtol=0, atol=0)


def _assert_grads_close(got, want, dtype, names):
    for g, w, name in zip(got, want, names):
        assert g.dtype == w.dtype, name
        scale = float(w.float().abs().max())
        torch.testing.assert_close(g.float(), w.float(), rtol=0, atol=GRAD_TOL[dtype] * scale, msg=name)


def test_convlstm_scan_gradient_matches_autograd(cuda):
    """Under autograd the forward kernel keeps the c stack and the backward
    kernels give the gradients of autograd through the plain loop (f32)."""
    args = _inputs(1, 2, 4, 4, 4, 3, torch.float32, cuda)
    leaves = [a.clone().requires_grad_(True) for a in args]
    ref = [a.clone().requires_grad_(True) for a in args]
    counts = (convlstm_fwd.launches, convlstm_bwd.calls)
    y, (h, c) = convlstm_scan(*leaves)
    y_p, (h_p, c_p) = convlstm_scan_reference(*ref)
    w = torch.randn(y.shape, generator=torch.Generator().manual_seed(5)).to(cuda)
    ((y * w).sum() + (h * c).sum()).backward()
    ((y_p * w).sum() + (h_p * c_p).sum()).backward()
    torch.cuda.synchronize()
    assert (convlstm_fwd.launches, convlstm_bwd.calls) == (counts[0] + 2, counts[1] + 1)
    _assert_grads_close([x.grad for x in leaves], [x.grad for x in ref], torch.float32,
                        ("dx", "dh0", "dc0", "drk", "db"))


def _bwd_args(fwd_ref, args, dev, seed):
    """The forward's stacks and random cotangents for a backward call."""
    y, cs, h, c = fwd_ref(*args)
    g = torch.Generator().manual_seed(seed)
    dy = torch.randn(y.shape, generator=g).to(dev, y.dtype)
    dh, dc = (torch.randn(h.shape, generator=g).to(dev) for _ in range(2))
    return (y, cs), (y, cs, h, c), (dy, dh, dc)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "b,h,w,f,k",
    [(1, 6, 6, 2, 3), (2, 5, 7, 4, 4), (2, 9, 13, 40, 5), (2, 7, 7, 8, 8), (2, 4, 4, 256, 5),
     (2, 3, 18, 33, 2), (1, 20, 20, 16, 8)],
)
def test_convlstm_backward_matches_plain(cuda, b, h, w, f, k, dtype):
    args = _inputs(b, 4, h, w, f, k, dtype, cuda, seed=f + k)
    with torch.no_grad():
        (y, cs), fwd_k, cot = _bwd_args(convlstm_fwd_reference, args, cuda, seed=k)
        got_fwd = convlstm_fwd(*args, with_c_stack=True)
        launches = convlstm_bwd.launches
        got = convlstm_bwd(*args, y, cs, *cot)
        want = convlstm_bwd_reference(*args, y, cs, *cot)
    torch.cuda.synchronize()
    assert convlstm_bwd.launches == launches + 2 * 4 + 2
    for g, r in zip(got_fwd, fwd_k):
        torch.testing.assert_close(g.float(), r.float(), rtol=0, atol=TOL[dtype])
    _assert_grads_close(got, want, dtype, ("dx", "dh0", "dc0", "drk", "db"))


def _lstm_inputs(b, t, u, dtype, dev, seed=0):
    g = torch.Generator().manual_seed(seed)
    xproj = torch.randn(b, t, 4 * u, generator=g).to(dev, dtype)
    h0 = (torch.randn(b, u, generator=g) * 0.5).to(dev)
    c0 = (torch.randn(b, u, generator=g) * 0.5).to(dev)
    rk = (torch.randn(u, 4 * u, generator=g) * u ** -0.5).to(dev)
    bias = (torch.randn(4 * u, generator=g) * 0.1).to(dev)
    return xproj, h0, c0, rk, bias


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,u,act", [(1, 3, 3, "tanh"), (5, 4, 3, "sigmoid"), (3, 6, 64, "tanh"),
                                       (4, 5, 8, "sigmoid")])
def test_lstm_kernels_match_plain(cuda, b, t, u, act, dtype):
    args = _lstm_inputs(b, t, u, dtype, cuda, seed=u)
    with torch.no_grad():
        (y, cs), fwd_p, cot = _bwd_args(lambda *a: lstm_scan_reference(*a, act), args, cuda, seed=b)
        calls = (lstm_fwd.launches, lstm_bwd.launches)
        got_fwd = lstm_fwd(*args, act, with_c_stack=True)
        got = lstm_bwd(*args, y, cs, *cot, act)
        want = lstm_bwd_reference(*args, y, cs, *cot, act)
    torch.cuda.synchronize()
    assert (lstm_fwd.launches, lstm_bwd.launches) == (calls[0] + 1, calls[1] + 3)
    for g, r in zip(got_fwd, fwd_p):
        torch.testing.assert_close(g.float(), r.float(), rtol=0, atol=TOL[dtype])
    _assert_grads_close(got, want, dtype, ("dx", "dh0", "dc0", "dR", "db"))
    with pytest.raises(TypeError):
        lstm_fwd(args[0].half(), *args[1:], act)
    with pytest.raises(ValueError, match="contiguous"):
        lstm_fwd(torch.cat([args[0], args[0]], dim=-1)[..., ::2], *args[1:], act)


def test_kernel_rejects_what_it_does_not_take(cuda):
    xconv, h0, c0, rk, bias = _inputs(1, 2, 4, 4, 4, 3, torch.float32, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        convlstm_scan(xconv, h0.transpose(1, 2), c0, rk, bias)
    with pytest.raises(TypeError):
        convlstm_scan(xconv.half(), h0, c0, rk, bias)
    with pytest.raises(TypeError):
        convlstm_scan(xconv, h0.double(), c0, rk, bias)
    with pytest.raises(ValueError, match="shape"):
        convlstm_scan(xconv, h0[:, :3].contiguous(), c0, rk, bias)


def _costs(k, b, dev, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(k, b, b, generator=g).abs() + 0.1).to(dev)


@pytest.mark.parametrize("b", [2, 6, 33, 128])
def test_sinkhorn_kernels_match_plain(cuda, b):
    c = _costs(3, b, cuda, seed=b)
    eps, num_iters = 0.7, 30
    f0, b0 = sinkhorn_fwd.launches, sinkhorn_bwd.launches
    cost_k, uh_k, vh_k = sinkhorn_fwd(c, eps, num_iters)
    cost_p, uh_p, vh_p = sinkhorn_fwd_reference(c, eps, num_iters)
    g = torch.tensor([2.0, -1.0, -1.0], device=cuda)
    cbar_k = sinkhorn_bwd(c, uh_k, vh_k, g, eps)
    cbar_p = sinkhorn_bwd_reference(c, uh_p, vh_p, g, eps)
    torch.cuda.synchronize()
    assert (sinkhorn_fwd.launches, sinkhorn_bwd.launches) == (f0 + 1, b0 + 1)
    torch.testing.assert_close(cost_k, cost_p, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(uh_k, uh_p, rtol=0, atol=1e-4)
    torch.testing.assert_close(vh_k, vh_p, rtol=0, atol=1e-4)
    torch.testing.assert_close(cbar_k, cbar_p, rtol=1e-4, atol=1e-6)
    # the autograd Function runs the same two kernels, and agrees with
    # autograd through the plain loop
    c1 = c.clone().requires_grad_(True)
    (sinkhorn_batch(c1, eps, num_iters) * g).sum().backward()
    c2 = c.clone().requires_grad_(True)
    (sinkhorn_fwd_reference(c2, eps, num_iters)[0] * g).sum().backward()
    torch.testing.assert_close(c1.grad, c2.grad, rtol=1e-4, atol=1e-6)


def test_sinkhorn_rejects_what_it_does_not_take(cuda):
    c = _costs(2, 4, cuda)
    with pytest.raises(TypeError):
        sinkhorn_fwd(c.double(), 1.0, 3)
    with pytest.raises(ValueError, match="contiguous"):
        sinkhorn_fwd(c.transpose(1, 2), 1.0, 3)
    with pytest.raises(ValueError, match="limit"):
        sinkhorn_fwd(_costs(1, 512, cuda), 1.0, 3)
    big = _costs(1, 200, cuda)  # within the forward's limit, beyond the backward's
    _, uh, vh = sinkhorn_fwd_reference(big, 1.0, 2)
    with pytest.raises(ValueError, match="limit"):
        sinkhorn_bwd(big, uh, vh, torch.ones(1, device=cuda), 1.0)
