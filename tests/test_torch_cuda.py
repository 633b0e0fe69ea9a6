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
and db; the kernels' recurrent-dropout mode (four masks, gate g's conv
over h_{t-1} * mask_g) at the same kinds of shape in both dtypes, under
autograd, and its weight gradient bitwise over two calls.  At the
flagship's 8 ConvLSTM layer shapes (B = 32, the training T), bf16
unmasked and masked and one f32 layer: the gate stack the forward keeps
for the backward against the plain recurrence's pre-activations, and the
backward kernels on it against the plain backward.  The LSTM
shapes: B=1, U=3 (an odd U, and fewer units than a warp), ragged row
blocks (B=5, 17, 33), U=64, whose staged recurrent kernel needs more
than 48 KiB of shared memory, the flagship's B=32, T=20 at U = 8, 32, 64
on the bf16 tensor-core path, U = 3, 5, 20 (not multiples of 8), a
batch beyond one thread-block cluster (the backward's second launch),
the bitwise determinism of dR and db, and None cotangents; past U = 64
(bf16 up to 128 on the tensor cores, else R read through L2; dR and db
in a second launch) U = 96, 128 and 256 in both dtypes, and dR and db
bitwise at U = 128.  The instance axis (N problems, each its own
weights, in the launches of one): U = 8 and 64 at B=32, B = 130 (the
second launch per instance) and U = 128, each instance equal to its
one-instance call to the bit, and ``lstm_scan`` under ``torch.func.vmap``
launching once.  The Sinkhorn sizes cover each path and its edges: the
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

The training step replayed from a CUDA graph (``build_train_step`` on the
card, ``train/graph.py::StepGraph``) against the eager step (the same
step given the identity ``Placement``, which the gate leaves eager) over
four steps from one state, batches and noise, in f32 and bf16, for each
option the gate sends to the graph (``GRAPHED``: both engines, both
Sinkhorn solvers, ``fused_discriminators``, smoothing at one sigma):
under cuDNN's deterministic algorithms every loss, pM, parameter, moment
and statistic equal to the bit; nothing a step returned is written by a
later one; one capture and three replays; the kernels' counters
advancing in each replay by an eager iteration's counts.  A traced
replay runs every kernel of a traced eager step that is not PyTorch's
own, by name and count.  Under cuDNN's default algorithms, where runs of
f32 differ, graphed runs differ from eager ones no more than runs of
either differ among themselves.  Dropout and decaying smoothing stay
eager on the card.
"""

import collections
import dataclasses
import threading

import numpy as np
import pytest
import torch

from kccotgan_tpu_torch.config import ModelConfig, TrainConfig
from kccotgan_tpu_torch.data import bouncing_blobs, device_prefetch

from kccotgan_tpu_torch.models.cuda_convlstm import (
    _fwd_plain,
    convlstm_bwd,
    convlstm_bwd_reference,
    convlstm_fwd,
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

from kccotgan_tpu_torch.train import build_train_step, create_train_state
from kccotgan_tpu_torch.train.state import state_tensors
from kccotgan_tpu_torch.train.steps import _KERNEL_COUNTERS, Placement, replays_graph

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


def _convlstm_bwd_args(args, dev, seed, masks=None):
    """The plain forward's ``(y, c_stack, h_n, c_n, gates)`` and ``hm``,
    and random cotangents for a backward call."""
    y, cs, h, c, hm, gates = _fwd_plain(*args, masks, with_gates=True)
    g = torch.Generator().manual_seed(seed)
    dy = torch.randn(y.shape, generator=g).to(dev, y.dtype)
    dh, dc = (torch.randn(h.shape, generator=g).to(dev) for _ in range(2))
    return (y, cs, h, c, gates), hm, (dy, dh, dc)


def _assert_fwd_close(got, want, dtype):
    """The forward's ``(y, c_stack, h_n, c_n, gates)`` at the forward's
    tolerance."""
    for name, g, r in zip(("y", "c_stack", "h_n", "c_n", "gates"), got, want):
        assert g.shape == r.shape and g.dtype == r.dtype, name
        torch.testing.assert_close(g.float(), r.float(), rtol=0, atol=TOL[dtype], msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "b,h,w,f,k",
    [(1, 6, 6, 2, 3), (2, 5, 7, 4, 4), (2, 9, 13, 40, 5), (2, 7, 7, 8, 8), (2, 4, 4, 256, 5),
     (2, 3, 18, 33, 2), (1, 20, 20, 16, 8)],
)
def test_convlstm_backward_matches_plain(cuda, b, h, w, f, k, dtype):
    """The forward kernel's stacks (the gate stack too) against the plain
    forward's, and the backward kernels on them against the plain
    backward, which recomputes the gates from the same y."""
    args = _inputs(b, 4, h, w, f, k, dtype, cuda, seed=f + k)
    with torch.no_grad():
        fwd_p, _, cot = _convlstm_bwd_args(args, cuda, seed=k)
        got_fwd = convlstm_fwd(*args, with_c_stack=True)
        y, cs, _, _, gates = got_fwd
        launches = convlstm_bwd.launches
        got = convlstm_bwd(gates, *args[1:4], y, cs, *cot)
        want = convlstm_bwd_reference(*args, y, cs, *cot)
    torch.cuda.synchronize()
    assert convlstm_bwd.launches == launches + 2 * 4 + 2
    _assert_fwd_close(got_fwd, fwd_p, dtype)
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
        fwd_p, _, cot = _convlstm_bwd_args(args, cuda, seed=f)
        got_fwd = convlstm_fwd(*args, with_c_stack=True)
        y, cs, _, _, gates = got_fwd
        got = convlstm_bwd(gates, *args[1:4], y, cs, *cot)
        want = convlstm_bwd_reference(*args, y, cs, *cot)
    torch.cuda.synchronize()
    _assert_fwd_close(got_fwd, fwd_p, torch.bfloat16)
    _assert_grads_close(got, want, torch.bfloat16, ("dx", "dh0", "dc0", "drk", "db"))


def test_weight_gradient_is_deterministic(cuda):
    """drk and db (split-K partials and db rows summed in a fixed order,
    no atomics) come out bitwise equal from two calls, bf16 and f32."""
    for dtype in (torch.bfloat16, torch.float32):
        args = _inputs(4, 6, 8, 8, 32, 5, dtype, cuda, seed=11)
        with torch.no_grad():
            (y, cs, _, _, gates), _, cot = _convlstm_bwd_args(args, cuda, seed=12)
            first = convlstm_bwd(gates, *args[1:4], y, cs, *cot)
            second = convlstm_bwd(gates, *args[1:4], y, cs, *cot)
        torch.cuda.synchronize()
        for name, a, b in zip(("dx", "dh0", "dc0", "drk", "db"), first, second):
            assert torch.equal(a, b), (dtype, name)


# The 8 ConvLSTM layers of mmnist_full at B = 32: (H = W, f, k, the
# training T: 20 for the encoder, 10 for the decoder)
FLAGSHIP = {"enc1": (32, 32, 6, 20), "enc2": (16, 64, 6, 20), "enc3": (8, 128, 5, 20),
            "enc4": (4, 256, 5, 20), "dec2": (8, 128, 4, 10), "dec3": (16, 64, 6, 10),
            "dec4": (32, 32, 8, 10), "dec5": (64, 8, 8, 10)}


@pytest.mark.parametrize(
    "layer,dtype,masked",
    [(n, torch.bfloat16, m) for n in FLAGSHIP for m in (False, True)] + [("enc3", torch.float32, False)],
)
def test_gate_stack_at_the_flagship_layers(cuda, layer, dtype, masked):
    """At the flagship's layer shapes, unmasked and masked in bf16 and at
    one f32 layer: the gate stack the forward writes (one a call, counted)
    is the plain recurrence's pre-activations at the forward's tolerance,
    and the backward kernels on it give the plain backward's gradients."""
    hw, f, k, t = FLAGSHIP[layer]
    args = _inputs(32, t, hw, hw, f, k, dtype, cuda, seed=f + k)
    masks = _rec_masks(32, hw, hw, f, cuda, seed=k) if masked else None
    with torch.no_grad():
        fwd_p, _, cot = _convlstm_bwd_args(args, cuda, seed=k, masks=masks)
        stacks = convlstm_fwd.gate_stacks
        y, cs, h_n, c_n, gates, *hm = convlstm_fwd(*args, with_c_stack=True, rec_masks=masks)
        assert convlstm_fwd.gate_stacks == stacks + 1
        hm = hm[0] if masked else None
        got = convlstm_bwd(gates, *args[1:4], y, cs, *cot, rec_masks=masks, hm=hm)
        want = convlstm_bwd_reference(*args, y, cs, *cot, rec_masks=masks, hm=hm)
    torch.cuda.synchronize()
    _assert_fwd_close((y, cs, h_n, c_n, gates), fwd_p, dtype)
    _assert_grads_close(got, want, dtype, ("dx", "dh0", "dc0", "drk", "db"))


def _rec_masks(b, h, w, f, dev, seed, keep=0.7):
    """Keras recurrent-dropout masks ``[4, B, H, W, f]``: 0 or 1 / keep."""
    g = torch.Generator().manual_seed(seed)
    return ((torch.rand(4, b, h, w, f, generator=g) < keep).float() / keep).to(dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "b,h,w,f,k",
    [(1, 6, 6, 2, 3), (3, 5, 7, 16, 3), (2, 9, 13, 40, 5), (2, 7, 7, 8, 8), (2, 4, 4, 256, 5),
     (1, 9, 9, 12, 3), (2, 16, 16, 32, 6)],
)
def test_recurrent_dropout_kernels_match_plain(cuda, b, h, w, f, k, dtype):
    """The kernels' masked mode (Keras recurrent dropout, gate g's conv
    over h_{t-1} * mask_g): forward and backward against the plain
    versions with the same masks, with the launches of the unmasked
    kernels.  Shapes as the unmasked tests (f = 2 and 12 take the
    element-by-element gathers, 4x4 at f = 256 the widest staged tile),
    and the 16x16 frame at f = 32, k = 6 of the first encoder layer."""
    t = 4
    args = _inputs(b, t, h, w, f, k, dtype, cuda, seed=5 * f + k)
    masks = _rec_masks(b, h, w, f, cuda, seed=f)
    with torch.no_grad():
        fwd_p, hm, cot = _convlstm_bwd_args(args, cuda, seed=k, masks=masks)
        launches = (convlstm_fwd.launches, convlstm_bwd.launches)
        got_fwd = convlstm_fwd(*args, with_c_stack=True, rec_masks=masks)
        y, cs, _, _, gates, hm_k = got_fwd
        got = convlstm_bwd(gates, *args[1:4], y, cs, *cot, rec_masks=masks, hm=hm_k)
        want = convlstm_bwd_reference(*args, y, cs, *cot, rec_masks=masks, hm=hm_k)
    torch.cuda.synchronize()
    assert (convlstm_fwd.launches, convlstm_bwd.launches) == (launches[0] + t, launches[1] + 2 * t + 2)
    _assert_fwd_close(got_fwd, fwd_p, dtype)
    # hm, the masked h's the gates read (its last slot is never read)
    torch.testing.assert_close(hm_k[0].float(), hm[0].float(), rtol=0, atol=TOL[dtype])
    torch.testing.assert_close(hm_k[1][:, : t - 1].float(), hm[1][:, : t - 1].float(),
                               rtol=0, atol=TOL[dtype] * 2)
    _assert_grads_close(got, want, dtype, ("dx", "dh0", "dc0", "drk", "db"))


def test_recurrent_dropout_autograd_and_determinism(cuda):
    """``convlstm_scan`` with masks under autograd gives autograd's
    gradients through the plain loop (f32), and the masked weight
    gradient is bitwise equal over two calls (bf16)."""
    args = _inputs(2, 3, 8, 8, 16, 5, torch.float32, cuda, seed=21)
    masks = _rec_masks(2, 8, 8, 16, cuda, seed=22)
    leaves = [a.clone().requires_grad_(True) for a in args]
    ref = [a.clone().requires_grad_(True) for a in args]
    y, (h, c) = convlstm_scan(*leaves, masks)
    y_p, (h_p, c_p) = convlstm_scan_reference(*ref, masks)
    w = torch.randn(y.shape, generator=torch.Generator().manual_seed(5)).to(cuda)
    ((y * w).sum() + (h * c).sum()).backward()
    ((y_p * w).sum() + (h_p * c_p).sum()).backward()
    _assert_grads_close([x.grad for x in leaves], [x.grad for x in ref], torch.float32,
                        ("dx", "dh0", "dc0", "drk", "db"))
    args = _inputs(4, 6, 8, 8, 32, 5, torch.bfloat16, cuda, seed=23)
    masks = _rec_masks(4, 8, 8, 32, cuda, seed=24)
    with torch.no_grad():
        y, cs, h_n, c_n, hm, gates = _fwd_plain(*args, masks, with_gates=True)
        cot = (torch.ones_like(y), torch.ones_like(h_n), torch.zeros_like(c_n))
        first = convlstm_bwd(gates, *args[1:4], y, cs, *cot, rec_masks=masks, hm=hm)
        second = convlstm_bwd(gates, *args[1:4], y, cs, *cot, rec_masks=masks, hm=hm)
    for name, a, b in zip(("dx", "dh0", "dc0", "drk", "db"), first, second):
        assert torch.equal(a, b), name


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


def _instanced(n, b, t, u, dtype, dev, seed=0):
    """``n`` problems, each its own inputs and weights, stacked on a
    leading instance axis."""
    return [torch.stack(a).contiguous() for a in zip(*(_lstm_inputs(b, t, u, dtype, dev, seed + i)
                                                       for i in range(n)))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,b,u,act,launches", [(4, 32, 8, "sigmoid", 1), (4, 32, 64, "tanh", 1),
                                                (3, 130, 32, "tanh", 2), (4, 32, 128, "tanh", 2)])
def test_instanced_lstm_kernels(cuda, n, b, u, act, launches, dtype):
    """N instances in the launches of one call: within the plain versions'
    tolerances, and each equal to the one-instance call on its slice to
    the bit.  U = 8 and 64 at the flagship's B=32, T=20 (one cluster an
    instance); B = 130 at U = 32, 17 blocks an instance in either dtype
    (the scratch's second launch, summed per instance); U = 128, past the
    staged kernels (bf16 on the tensor cores at KT = 8, f32 through L2;
    dR and db in a second launch)."""
    args = _instanced(n, b, 20 if b <= 32 else 5, u, dtype, cuda, seed=u + n)
    with torch.no_grad():
        (y, cs), fwd_p, cot = _bwd_args(lambda *a: lstm_scan_reference(*a, act), args, cuda, seed=b)
        before = (lstm_fwd.launches, lstm_bwd.launches)
        got_fwd = lstm_fwd(*args, act, with_c_stack=True)
        got = lstm_bwd(*args, y, cs, *cot, act)
        launched = (lstm_fwd.launches - before[0], lstm_bwd.launches - before[1])
        want = lstm_bwd_reference(*args, y, cs, *cot, act)
        single_fwd = [lstm_fwd(*(a[i] for a in args), act, with_c_stack=True) for i in range(n)]
        single = [lstm_bwd(*(a[i] for a in (*args, y, cs, *cot)), act) for i in range(n)]
    torch.cuda.synchronize()
    assert launched == (1, launches)
    for g, r in zip(got_fwd, fwd_p):
        torch.testing.assert_close(g.float(), r.float(), rtol=0, atol=TOL[dtype])
    _assert_grads_close(got, want, dtype, ("dx", "dh0", "dc0", "dR", "db"))
    for i in range(n):
        for name, a, one in zip(("y", "c_stack", "h_n", "c_n"), got_fwd, single_fwd[i]):
            assert torch.equal(a[i], one), (i, name)
        for name, a, one in zip(("dx", "dh0", "dc0", "dR", "db"), got, single[i]):
            assert torch.equal(a[i], one), (i, name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lstm_scan_under_vmap_launches_once(cuda, dtype):
    """``torch.func.vmap`` over ``lstm_scan`` (the fused discriminators'
    route): one forward and one backward launch for the four instances,
    outputs and every gradient equal to per-instance calls to the bit."""
    args = _instanced(4, 32, 20, 32, dtype, cuda, seed=40)
    w = torch.randn(args[0].shape[:-1] + (32,), generator=torch.Generator().manual_seed(6)).to(cuda, dtype)
    leaves = [a.clone().requires_grad_(True) for a in args]
    before = (lstm_fwd.launches, lstm_bwd.launches)
    y, (h, c) = torch.func.vmap(lstm_scan)(*leaves)
    torch.autograd.backward((y, h), (w, torch.ones_like(h)))
    torch.cuda.synchronize()
    assert (lstm_fwd.launches - before[0], lstm_bwd.launches - before[1]) == (1, 1)
    ref = [a.clone().requires_grad_(True) for a in args]
    outs = [lstm_scan(*(a[i] for a in ref)) for i in range(4)]
    y_1, h_1 = torch.stack([o[0] for o in outs]), torch.stack([o[1][0] for o in outs])
    torch.autograd.backward((y_1, h_1), (w, torch.ones_like(h_1)))
    assert torch.equal(y, y_1) and torch.equal(h, h_1)
    for name, a, b in zip(("dx", "dh0", "dc0", "dR", "db"), leaves, ref):
        assert torch.equal(a.grad, b.grad), name


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


STEP_CFG = TrainConfig(
    dname="synthetic", batch_size=4, total_time_steps=4, int_time_steps=2, sinkhorn_l=5, warmup_steps=1,
    kernel_impl="pallas",
    model=ModelConfig(x_height=16, x_width=16, g_filter_size=2, d_filter_size=1, d_state_size=2,
                      z_channels=2, z_height=1, z_width=1),
)
# each option the gate sends to the graph and the step's code branches on
GRAPHED = {
    "pallas": {},
    "fused": {"fused_discriminators": True},
    "scan_engine": {"kernel_impl": "scan"},
    "scan_solver": {"sinkhorn_solver": "scan"},
    "smooth_1d": {"kernel": "1d"},
    "smooth_2d": {"kernel": "2d"},
    "smooth_3d": {"kernel": "3d"},
    "decaying_unread": {"decaying_sigma": True},
}


def _step_tensors(state, metrics):
    return {**state_tensors(state), "loss": metrics["sinkhorn_loss"], "pm": metrics["pm"]}


def _eager_step(cfg, dev):
    """The same step, left eager by the gate (the identity ``Placement``)."""
    return build_train_step(cfg, device=dev, placement=Placement())


def _four_steps(step, cfg, dev, seed=0):
    """Four steps from the state seeded with ``seed``, each with its own
    batch and injected noise: per step the tensors returned (and a copy
    taken at once), and the kernel counters' advance."""
    state = create_train_state(cfg, generator=torch.Generator().manual_seed(seed), device=dev)
    data = torch.from_numpy(bouncing_blobs(16, cfg.total_time_steps, 16, 16, seed=3 + seed)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(7 + seed)
    zshape = (cfg.batch_size, cfg.pred_time_steps, 1, 1, 2)
    out = []
    for i in range(4):
        z = tuple(torch.randn(zshape, generator=gen, device=dev) for _ in range(2))
        before = [getattr(obj, name) for obj, name in _KERNEL_COUNTERS]
        state, metrics = step(state, data[4 * i: 4 * i + 4], z=z)
        torch.cuda.synchronize()
        got = _step_tensors(state, metrics)
        out.append((got, {k: v.clone() for k, v in got.items()},
                    [getattr(obj, name) - n for (obj, name), n in zip(_KERNEL_COUNTERS, before)]))
    return out


@pytest.mark.parametrize("variant", list(GRAPHED))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_graphed_step_equals_the_eager_step(cuda, dtype, variant):
    """Under cuDNN's deterministic algorithms two eager runs agree, and
    the graphed step equals them to the bit everywhere."""
    cfg = dataclasses.replace(STEP_CFG, compute_dtype=dtype, **GRAPHED[variant])
    assert replays_graph(cfg, cuda)
    torch.backends.cudnn.deterministic = True
    try:
        eager = [_four_steps(_eager_step(cfg, cuda), cfg, cuda) for _ in range(2)]
        step = build_train_step(cfg, device=cuda)
        graphed = _four_steps(step, cfg, cuda)
    finally:
        torch.backends.cudnn.deterministic = False
    assert step.counts == {"eager": 1, "captures": 1, "replays": 3}
    for (got, _, launched), (e1, _, eager_launched), (e2, _, _) in zip(graphed, *eager):
        assert launched == eager_launched and sum(launched) > 0
        for name, g in got.items():
            assert torch.equal(e1[name], e2[name]), f"deterministic eager runs differ: {name}"
            assert torch.equal(g, e1[name]), name
    for got, then, _ in graphed:  # nothing a step returned was written by a later step
        assert all(torch.equal(got[k], then[k]) for k in got)

GAP_RUNS = 5
GAP_FACTOR = 2


def _largest_gaps(pairs):
    """Per leaf, the largest difference over ``pairs`` of runs' tensors."""
    return {k: max(float((a[k] - b[k]).abs().max()) for a, b in pairs) for k in pairs[0][0]}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("fused", [False, True], ids=["sequential", "fused"])
def test_graphed_step_lies_among_eager_runs_under_default_algorithms(cuda, fused, seed):
    """f32 under cuDNN's default algorithms, which sum some weight
    gradients with atomics in an order that changes run to run, and
    changes more from replay to replay than from one eager run to the
    next (the replay runs the eager step's kernels, as
    ``test_a_replay_runs_the_eager_steps_kernels`` checks).  GAP_RUNS
    eager runs and GAP_RUNS graphed runs, each captured anew, from one
    seeded state, batches and noise: no leaf differs between a graphed
    and an eager run that differs neither between two graphed runs nor
    between two eager ones, and per leaf the largest gap across the two
    is within GAP_FACTOR of the largest within either, as it would be
    were the graphed runs more eager runs."""
    cfg = dataclasses.replace(STEP_CFG, compute_dtype="float32", fused_discriminators=fused)
    eager = [_four_steps(_eager_step(cfg, cuda), cfg, cuda, seed)[-1][0] for _ in range(GAP_RUNS)]
    graphed = [_four_steps(build_train_step(cfg, device=cuda), cfg, cuda, seed)[-1][0] for _ in range(GAP_RUNS)]
    within = _largest_gaps([(a, b) for runs in (eager, graphed) for i, a in enumerate(runs) for b in runs[i + 1:]])
    across = _largest_gaps([(g, e) for g in graphed for e in eager])
    print(f"[graphed step f32 fused={fused} seed={seed}] leaves that differ run to run: "
          f"{sorted(k for k, v in within.items() if v)}")
    assert not [k for k, v in across.items() if v and not within[k]], "leaves only the graph changes"
    over = {k: (across[k], within[k]) for k in across if across[k] > GAP_FACTOR * within[k]}
    assert not over, over


def _kernel_counts(fn):
    """Device events by name in a ``torch.profiler`` trace of ``fn()``."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return collections.Counter(e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)


def _torch_own(name):
    """PyTorch's own elementwise, copy and fill work (a graph runs some
    copies and fills as CUDA's own ``memcpy*`` / ``memset*`` kernels),
    which the replay's copies add to and Adam's device-held step size
    renames."""
    return name.startswith(("void at::native::", "Memcpy", "Memset", "memcpy", "memset"))


@pytest.mark.parametrize("fused", [False, True], ids=["sequential", "fused"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_a_replay_runs_the_eager_steps_kernels(cuda, dtype, fused):
    """One eager step and one replay from the same state, batch and
    noise, each traced, under cuDNN's default algorithms: every kernel
    that is not PyTorch's own (the hand-written ones, cuDNN's, cuBLAS's)
    runs in the replay as often as in the eager step and under the same
    name, so the capture keeps the eager step's algorithms; and the
    counters of the hand-written kernels advance alike in both."""
    cfg = dataclasses.replace(STEP_CFG, compute_dtype=dtype, fused_discriminators=fused)
    state = create_train_state(cfg, device=cuda)
    batch = torch.from_numpy(bouncing_blobs(4, cfg.total_time_steps, 16, 16, seed=3)).to(cuda)
    z = tuple(torch.randn(cfg.batch_size, cfg.pred_time_steps, 1, 1, 2, device=cuda) for _ in range(2))
    steps = {"eager": _eager_step(cfg, cuda), "replay": build_train_step(cfg, device=cuda)}
    traced = {}
    for name, step in steps.items():
        for _ in range(2):  # the graphed step's warm-up and capture
            step(state, batch, z=z)
        before = [getattr(obj, n) for obj, n in _KERNEL_COUNTERS]
        counts = _kernel_counts(lambda: step(state, batch, z=z))
        traced[name] = ({k: v for k, v in counts.items() if not _torch_own(k)},
                        [getattr(obj, n) - b for (obj, n), b in zip(_KERNEL_COUNTERS, before)])
    assert steps["replay"].counts == {"eager": 1, "captures": 1, "replays": 2}
    (eager, eager_launched), (replay, launched) = traced["eager"], traced["replay"]
    assert any("convlstm_" in k for k in eager), sorted(eager)
    assert replay == eager, (collections.Counter(replay) - collections.Counter(eager),
                             collections.Counter(eager) - collections.Counter(replay))
    assert launched == eager_launched


@pytest.mark.parametrize("over", [{"model": dataclasses.replace(STEP_CFG.model, dropout=0.1)},
                                  {"kernel": "1d", "decaying_sigma": True}], ids=["dropout", "decaying_1d"])
def test_steps_the_gate_leaves_out_run_eagerly_on_the_card(cuda, over):
    cfg = dataclasses.replace(STEP_CFG, **over)
    step = build_train_step(cfg, device=cuda)
    _four_steps(step, cfg, cuda)
    assert step.counts == {"eager": 4, "captures": 0, "replays": 0}
