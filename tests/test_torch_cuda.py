"""The CUDA kernels vs their plain PyTorch versions, on the card.

Needs an NVIDIA GPU (and nvcc to build the kernel): every test skips
without one.  Imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports JAX; the ``cuda`` marker
is registered in ``pyproject.toml``.)  The ConvLSTM shapes are
the awkward ones ``chip_smoke.py`` does not reach: frames whose pixel
count is not a multiple of a thread's pixel run, channel counts that are not a
multiple of its 32-channel tile, a rectangular frame, and shared memory
beyond the default 48 KiB.  The Sinkhorn sizes cover fewer rows than a
warp (2, 6), a ragged second warp column (33) and shared memory beyond
48 KiB (128), at eps 0.7.

Tolerances: ConvLSTM f32 (TF32 off) at 2e-5 abs, summation order only;
bf16 at 2e-2 abs, one bf16 ulp of the once-rounded recurrent conv or of
y, carried over the steps.  Sinkhorn (f32): costs at rtol 1e-5 and
c_bar at rtol 1e-4 / atol 1e-6, the JAX package's tolerances for its
fused kernel against the scan (``tests/test_pallas_sinkhorn.py``), and
the histories at 1e-4 abs (the duals of B <= 128 points, of order 1 to
10, after L sums in another order).
"""

import pytest
import torch

from kccotgan_tpu_torch.models.cuda_convlstm import convlstm_scan, convlstm_scan_reference
from kccotgan_tpu_torch.ot.cuda_sinkhorn import (
    sinkhorn_batch,
    sinkhorn_bwd,
    sinkhorn_bwd_reference,
    sinkhorn_fwd,
    sinkhorn_fwd_reference,
)

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


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
    before = convlstm_scan.launches
    with torch.no_grad():
        y_k, (h_k, c_k) = convlstm_scan(*args)
        y_p, (h_p, c_p) = convlstm_scan_reference(*args)
    torch.cuda.synchronize()
    assert convlstm_scan.launches == before + 3
    assert y_k.dtype == dtype and h_k.dtype == c_k.dtype == torch.float32
    for got, want in ((y_k, y_p), (h_k, h_p), (c_k, c_p)):
        torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=TOL[dtype])
    # the caller's carry is read, never written
    torch.testing.assert_close(args[1], _inputs(2, 3, h, w, f, k, dtype, cuda)[1], rtol=0, atol=0)


def test_kernel_is_forward_only(cuda):
    xconv, h0, c0, rk, bias = _inputs(1, 2, 4, 4, 4, 3, torch.float32, cuda)
    rk.requires_grad_(True)
    with pytest.raises(NotImplementedError):
        convlstm_scan(xconv, h0, c0, rk, bias)


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
