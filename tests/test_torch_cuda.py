"""The CUDA kernels vs their plain PyTorch versions, on the card.

Needs an NVIDIA GPU (and nvcc to build the kernel): every test skips
without one.  Imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports JAX; the ``cuda`` marker
is registered in ``pyproject.toml``.)  The ConvLSTM shapes are
the awkward ones ``chip_smoke.py`` does not reach: frames whose pixel
count is not a multiple of a thread's pixel run, channel counts that are not a
multiple of its 32-channel tile, a rectangular frame, and shared memory
beyond the default 48 KiB; the backward adds B=1 and f=2.  The bf16
engine (tensor cores) adds ragged M, f = 8 and 256 on a 4x4 frame, f =
12 (its element-by-element gather) and the bitwise determinism of drk
and db.  The LSTM
shapes: B=1, U=3 (an odd U, and fewer units than a warp), ragged row
blocks (B=5, 17, 33), U=64, whose staged recurrent kernel needs more
than 48 KiB of shared memory, the flagship's B=32, T=20 at U = 8, 32, 64
on the bf16 tensor-core path, U = 3, 5, 20 (not multiples of 8), a
batch beyond one thread-block cluster (the backward's second launch),
the bitwise determinism of dR and db, and None cotangents; past U = 64
(bf16 up to 128 on the tensor cores, else R read through L2; dR and db
in a second launch) U = 96, 128 and 256 in both dtypes, and dR and db
bitwise at U = 128.  The Sinkhorn sizes cover each path and its edges: the
register path, a problem in one block's registers at 16 lanes a row (B =
1, 2, 6, 31 and 32 in the 32-row kernel; 33, the first of the 64-row
kernel), and the band path past B = 64, a thread-block cluster a problem
(128; 161 and 240, where one block's shared memory once ran out; 512,
C's bands in shared memory; 1024, C read through L2), at eps 0.7, one
launch each; and B = 8200, past the 8192 up to which the band path
stages u and v in shared memory, at L = 3.

Tolerances: ConvLSTM and LSTM forward f32 (TF32 off) at 2e-5 abs,
summation order only; bf16 at 2e-2 abs, one bf16 ulp of the once-rounded
recurrent conv or of y, carried over the steps.  Backward kernels: each
gradient within 1e-5 (f32) or 2e-2 (bf16) of its largest entry, the same
argument, the bf16 one as the CPU tests against JAX's VJP
(``test_torch_lstm.py``, ``test_torch_convlstm_grad.py``).  Sinkhorn (f32): costs at rtol 1e-5 and
c_bar at rtol 1e-4 / atol 1e-6, the JAX package's tolerances for its
fused kernel against the scan (``tests/test_pallas_sinkhorn.py``), and
the histories at 1e-4 abs (the duals, of order 1 to 10, after L sums in
another order); c_bar also within 1e-4 of its largest entry, since its
typical entry shrinks like 1 / B^2 and reaches the 1e-6 floor near B =
1024.

``device_prefetch`` on the card: each batch is handed over as soon as
its own copy is issued, not held back until the next one is pinned.
"""

import threading

import numpy as np
import pytest
import torch

from kccotgan_tpu_torch.data import device_prefetch

from kccotgan_tpu_torch.models.cuda_convlstm import (
    convlstm_bwd,
    convlstm_bwd_reference,
    convlstm_fwd,
    convlstm_fwd_reference,
    convlstm_scan,
    convlstm_scan_reference,
)
from kccotgan_tpu_torch.models.cuda_lstm import (
    lstm_bwd,
    lstm_bwd_reference,
    lstm_fwd,
    lstm_scan,
    lstm_scan_reference,
)
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


@pytest.mark.parametrize(
    "b,h,w,f,k",
    [(3, 5, 7, 16, 3), (2, 4, 4, 8, 8), (2, 4, 4, 256, 5), (3, 6, 6, 24, 4), (1, 9, 9, 12, 3)],
)
def test_tensor_core_path_matches_plain(cuda, b, h, w, f, k):
    """The bf16 engine (tensor cores) at ragged M (B=3 on 5x7 frames, not
    a multiple of any tile), f = 8 and f = 256 on a 4x4 frame, odd and
    even k, and f = 12 (channels not a multiple of 8: the gather copies
    element by element), forward and backward."""
    args = _inputs(b, 5, h, w, f, k, torch.bfloat16, cuda, seed=3 * f + k)
    with torch.no_grad():
        (y, cs), fwd_p, cot = _bwd_args(convlstm_fwd_reference, args, cuda, seed=f)
        got_fwd = convlstm_fwd(*args, with_c_stack=True)
        got = convlstm_bwd(*args, y, cs, *cot)
        want = convlstm_bwd_reference(*args, y, cs, *cot)
    torch.cuda.synchronize()
    for g, r in zip(got_fwd, fwd_p):
        torch.testing.assert_close(g.float(), r.float(), rtol=0, atol=TOL[torch.bfloat16])
    _assert_grads_close(got, want, torch.bfloat16, ("dx", "dh0", "dc0", "drk", "db"))


def test_weight_gradient_is_deterministic(cuda):
    """drk and db (split-K partials and db rows summed in a fixed order,
    no atomics) come out bitwise equal from two calls, bf16 and f32."""
    for dtype in (torch.bfloat16, torch.float32):
        args = _inputs(4, 6, 8, 8, 32, 5, dtype, cuda, seed=11)
        with torch.no_grad():
            (y, cs), _, cot = _bwd_args(convlstm_fwd_reference, args, cuda, seed=12)
            first = convlstm_bwd(*args, y, cs, *cot)
            second = convlstm_bwd(*args, y, cs, *cot)
        torch.cuda.synchronize()
        for name, a, b in zip(("dx", "dh0", "dc0", "drk", "db"), first, second):
            assert torch.equal(a, b), (dtype, name)


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
                                       (4, 5, 8, "sigmoid"), (32, 20, 64, "tanh")])
def test_lstm_kernels_match_plain(cuda, b, t, u, act, dtype):
    args = _lstm_inputs(b, t, u, dtype, cuda, seed=u)
    with torch.no_grad():
        (y, cs), fwd_p, cot = _bwd_args(lambda *a: lstm_scan_reference(*a, act), args, cuda, seed=b)
        calls = (lstm_fwd.launches, lstm_bwd.launches)
        got_fwd = lstm_fwd(*args, act, with_c_stack=True)
        got = lstm_bwd(*args, y, cs, *cot, act)
        want = lstm_bwd_reference(*args, y, cs, *cot, act)
    torch.cuda.synchronize()
    assert (lstm_fwd.launches, lstm_bwd.launches) == (calls[0] + 1, calls[1] + 1)
    for g, r in zip(got_fwd, fwd_p):
        torch.testing.assert_close(g.float(), r.float(), rtol=0, atol=TOL[dtype])
    _assert_grads_close(got, want, dtype, ("dx", "dh0", "dc0", "dR", "db"))
    with pytest.raises(TypeError):
        lstm_fwd(args[0].half(), *args[1:], act)
    with pytest.raises(ValueError, match="contiguous"):
        lstm_fwd(torch.cat([args[0], args[0]], dim=-1)[..., ::2], *args[1:], act)
    with pytest.raises(TypeError):
        lstm_fwd(*args[:3], args[3].half(), args[4], act)


def _lstm_check(args, act, dtype, cuda, seed, launches):
    """Forward and backward kernels vs their plain versions, with the
    backward's expected launches."""
    with torch.no_grad():
        (y, cs), fwd_p, cot = _bwd_args(lambda *a: lstm_scan_reference(*a, act), args, cuda, seed=seed)
        got_fwd = lstm_fwd(*args, act, with_c_stack=True)
        before = lstm_bwd.launches
        got = lstm_bwd(*args, y, cs, *cot, act)
        want = lstm_bwd_reference(*args, y, cs, *cot, act)
    torch.cuda.synchronize()
    assert lstm_bwd.launches == before + launches
    for g, r in zip(got_fwd, fwd_p):
        torch.testing.assert_close(g.float(), r.float(), rtol=0, atol=TOL[dtype])
    _assert_grads_close(got, want, dtype, ("dx", "dh0", "dc0", "dR", "db"))


@pytest.mark.parametrize(
    "b,t,u,act",
    [(32, 20, 8, "sigmoid"), (32, 20, 32, "tanh"), (32, 20, 64, "tanh"), (5, 7, 32, "tanh"),
     (33, 6, 64, "tanh"), (3, 5, 3, "tanh"), (33, 4, 5, "sigmoid"), (17, 3, 20, "tanh")],
)
def test_lstm_tensor_core_path_matches_plain(cuda, b, t, u, act):
    """The bf16 engine (tensor cores, 8 rows a block): the flagship's
    three layers at B=32, T=20; ragged B (5, 17, 33: a padded last
    block); U not a multiple of 8 (3, 5, 20), padded to the k16 step.
    One backward launch each: at most 8 blocks, one cluster."""
    _lstm_check(_lstm_inputs(b, t, u, torch.bfloat16, cuda, seed=u + b), act, torch.bfloat16,
                cuda, seed=t, launches=1)


@pytest.mark.parametrize("dtype,b,u", [(torch.bfloat16, 130, 32), (torch.float32, 40, 64),
                                       (torch.bfloat16, 65, 5)])
def test_lstm_backward_beyond_one_cluster(cuda, dtype, b, u):
    """More blocks than a cluster holds (bf16, 8 rows a block: B > 64; f32 at U=64, 4
    rows a block: B > 32): the partials go through the scratch buffer and
    a second, fixed-order launch."""
    _lstm_check(_lstm_inputs(b, 5, u, dtype, cuda, seed=b), "tanh", dtype, cuda, seed=u, launches=2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("u", [96, 128, 256])
def test_lstm_beyond_the_staged_kernels(cuda, u, dtype):
    """U > 64: bf16 up to 128 on the tensor cores (KT = 8), f32 and bf16
    past 128 through L2 (R read at every step, not staged); the
    backward's dR and db in a second launch either way."""
    _lstm_check(_lstm_inputs(32, 20, u, dtype, cuda, seed=u), "tanh", dtype, cuda, seed=u, launches=2)


def test_lstm_weight_gradient_is_deterministic(cuda):
    """dR and db (block partials summed in rank order, no atomics) come out
    bitwise equal from two calls, in one cluster, beyond one and past the
    staged kernels (U = 128), bf16 and f32; None cotangents give what zero
    ones give."""
    for dtype, b, u in ((torch.bfloat16, 32, 64), (torch.float32, 32, 64), (torch.bfloat16, 130, 8),
                        (torch.float32, 40, 64), (torch.float32, 7, 5), (torch.bfloat16, 32, 128),
                        (torch.float32, 32, 128)):
        args = _lstm_inputs(b, 20, u, dtype, cuda, seed=b + u)
        with torch.no_grad():
            (y, cs), _, (dy, dh, dc) = _bwd_args(lambda *a: lstm_scan_reference(*a, "tanh"), args, cuda, seed=3)
            first = lstm_bwd(*args, y, cs, dy, dh, dc)
            second = lstm_bwd(*args, y, cs, dy, dh, dc)
            nones = lstm_bwd(*args, y, cs, dy, None, None)
            zeros = lstm_bwd(*args, y, cs, dy, torch.zeros_like(dh), torch.zeros_like(dc))
        torch.cuda.synchronize()
        for name, x, z in zip(("dx", "dh0", "dc0", "dR", "db"), first, second):
            assert torch.equal(x, z), (dtype, b, name)
        for name, x, z in zip(("dx", "dh0", "dc0", "dR", "db"), nones, zeros):
            assert torch.equal(x, z), (dtype, b, "None cotangent", name)


def test_lstm_scan_gradient_matches_autograd(cuda):
    """Under autograd (y alone used: (h_n, c_n) get no cotangent, which
    reaches the kernel as None) the kernels give autograd's gradients
    through the plain loop (f32)."""
    args = _lstm_inputs(6, 5, 32, torch.float32, cuda, seed=9)
    leaves = [a.clone().requires_grad_(True) for a in args]
    ref = [a.clone().requires_grad_(True) for a in args]
    counts = (lstm_fwd.launches, lstm_bwd.launches)
    y, _ = lstm_scan(*leaves)
    y_p = lstm_scan_reference(*ref)[0]
    w = torch.randn(y.shape, generator=torch.Generator().manual_seed(5)).to(cuda)
    (y * w).sum().backward()
    (y_p * w).sum().backward()
    torch.cuda.synchronize()
    assert (lstm_fwd.launches, lstm_bwd.launches) == (counts[0] + 1, counts[1] + 1)
    torch.testing.assert_close(y, y_p, rtol=0, atol=TOL[torch.float32])
    _assert_grads_close([x.grad for x in leaves], [x.grad for x in ref], torch.float32,
                        ("dx", "dh0", "dc0", "dR", "db"))


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


def _assert_cbar_close(got, want):
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6)
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


# (K, B, L): the flagship's three problems at each size, and one problem
# of B = 8200 (C of 269 MB) at L = 3, past the 8192 up to which the band
# path stages u and v, so that autograd through the plain loop fits.
@pytest.mark.parametrize(
    "k, b, num_iters", [(3, b, 30) for b in (1, 2, 6, 31, 32, 33, 128, 161, 240, 512, 1024)] + [(1, 8200, 3)]
)
def test_sinkhorn_kernels_match_plain(cuda, k, b, num_iters):
    c = _costs(k, b, cuda, seed=b)
    eps = 0.7
    f0, b0 = sinkhorn_fwd.launches, sinkhorn_bwd.launches
    cost_k, uh_k, vh_k = sinkhorn_fwd(c, eps, num_iters)
    cost_p, uh_p, vh_p = sinkhorn_fwd_reference(c, eps, num_iters)
    g = torch.tensor([2.0, -1.0, -1.0], device=cuda)[:k]
    cbar_k = sinkhorn_bwd(c, uh_k, vh_k, g, eps)
    cbar_p = sinkhorn_bwd_reference(c, uh_p, vh_p, g, eps)
    torch.cuda.synchronize()
    assert (sinkhorn_fwd.launches, sinkhorn_bwd.launches) == (f0 + 1, b0 + 1)
    torch.testing.assert_close(cost_k, cost_p, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(uh_k, uh_p, rtol=0, atol=1e-4)
    torch.testing.assert_close(vh_k, vh_p, rtol=0, atol=1e-4)
    _assert_cbar_close(cbar_k, cbar_p)
    # the autograd Function runs the same two kernels, and agrees with
    # autograd through the plain loop
    c1 = c.clone().requires_grad_(True)
    (sinkhorn_batch(c1, eps, num_iters) * g).sum().backward()
    c2 = c.clone().requires_grad_(True)
    (sinkhorn_fwd_reference(c2, eps, num_iters)[0] * g).sum().backward()
    _assert_cbar_close(c1.grad, c2.grad)


def test_sinkhorn_rejects_what_it_does_not_take(cuda):
    """B = 200 (past the backward's block path) and 512 (past the
    forward's) run, one launch each; wrong dtypes, strides and devices
    raise."""
    for b in (200, 512):
        c = _costs(1, b, cuda, seed=b)
        f0, b0 = sinkhorn_fwd.launches, sinkhorn_bwd.launches
        cost, uh, vh = sinkhorn_fwd(c, 1.0, 3)
        c_bar = sinkhorn_bwd(c, uh, vh, torch.ones(1, device=cuda), 1.0)
        torch.cuda.synchronize()
        assert (sinkhorn_fwd.launches, sinkhorn_bwd.launches) == (f0 + 1, b0 + 1)
        assert bool(torch.isfinite(cost).all()) and bool(torch.isfinite(c_bar).all())
    c = _costs(2, 4, cuda)
    with pytest.raises(TypeError):
        sinkhorn_fwd(c.double(), 1.0, 3)
    with pytest.raises(ValueError, match="contiguous"):
        sinkhorn_fwd(c.transpose(1, 2), 1.0, 3)
    _, uh, vh = sinkhorn_fwd_reference(c, 1.0, 2)
    with pytest.raises(ValueError, match="devices"):
        sinkhorn_bwd(c, uh.cpu(), vh, torch.ones(2, device=cuda), 1.0)


def test_device_prefetch_hands_over_each_batch_before_the_next(cuda):
    """The source's second batch is made only after the consumer holds the
    first: a prefetch that waited for it before yielding the first would
    stall here until the source gives up and raises."""
    holds_first = threading.Event()

    def source():
        yield np.zeros((2, 3), np.float32)
        if not holds_first.wait(timeout=10):
            raise RuntimeError("the first batch was held back until the second was pinned")
        for i in (1, 2):
            yield np.full((2, 3), i, np.float32)

    it = device_prefetch(source(), device=cuda)
    first = next(it)
    holds_first.set()
    got = [first, *it]
    assert all(b.device.type == "cuda" and b.dtype == torch.float32 for b in got)
    assert [b.cpu().tolist() for b in got] == [[[float(i)] * 3] * 2 for i in range(3)]
