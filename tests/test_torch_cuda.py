"""The ConvLSTM CUDA kernel vs its plain PyTorch version, on the card.

Needs an NVIDIA GPU (and nvcc to build the kernel): every test skips
without one.  Imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports JAX; the ``cuda`` marker
is registered in ``pyproject.toml``.)  The shapes are
the awkward ones ``chip_smoke.py`` does not reach: frames whose pixel
count is not a multiple of a thread's pixel run, channel counts that are not a
multiple of its 32-channel tile, a rectangular frame, and shared memory
beyond the default 48 KiB.

Tolerances: f32 (TF32 off) at 2e-5 abs, summation order only; bf16 at
2e-2 abs, one bf16 ulp of the once-rounded recurrent conv or of y,
carried over the steps.
"""

import pytest
import torch

from kccotgan_tpu_torch.models.cuda_convlstm import convlstm_scan, convlstm_scan_reference

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
