"""The port's ConvLSTM recurrence under autograd (``ConvLstmScan``) vs the
JAX package's ``convlstm_scan_pallas`` and its VJP.

The same seeded numpy inputs go through ``jax.vjp`` of the Pallas
recurrence (interpret mode on the CPU) and through ``ConvLstmScan``,
whose forward and backward on CPU tensors are the kernels' plain versions
(``convlstm_fwd_reference``, ``convlstm_bwd_reference``).  Nonzero h0,
c0 and cotangents of y, h_n and c_n; an odd and an even kernel (the even
one pads (k-1)/2 before and the rest after, flipped in the adjoint).

Tolerances: f32 at 1e-5 abs (forward) and 2e-5 of each gradient's
largest entry: the same arithmetic, summed in another order.  bf16 at
one bf16 ulp of y (4e-3 abs) and 2e-2 of each gradient's largest entry:
both sides round h, the kernel, the recurrent conv, y and dz to bf16 at
the same points, but another f32 summation order can round one of them
one ulp (2**-8 relative) apart, and the adjoint carries that over the
steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kccotgan_tpu.models.pallas_convlstm import convlstm_scan_pallas
from kccotgan_tpu_torch.models import layers
from kccotgan_tpu_torch.models.cuda_convlstm import (
    ConvLstmScan,
    convlstm_bwd,
    convlstm_bwd_reference,
    convlstm_fwd,
    convlstm_fwd_reference,
)

torch.set_num_threads(1)

_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"float32": (1e-5, 2e-5), "bfloat16": (4e-3, 2e-2)}  # (forward abs, gradient rel)


def _inputs(seed, k, b=2, t=3, h=5, w=4, f=3):
    rng = np.random.default_rng(seed)
    return dict(
        xconv=rng.normal(size=(b, t, h, w, 4 * f)).astype(np.float32),
        h0=(rng.normal(size=(b, h, w, f)) * 0.5).astype(np.float32),
        c0=(rng.normal(size=(b, h, w, f)) * 0.5).astype(np.float32),
        rk=(rng.normal(size=(k, k, f, 4 * f)) * (k * k * f) ** -0.5).astype(np.float32),
        bias=(rng.normal(size=(4 * f,)) * 0.1).astype(np.float32),
        dy=rng.normal(size=(b, t, h, w, f)).astype(np.float32),
        dh=rng.normal(size=(b, h, w, f)).astype(np.float32),
        dc=rng.normal(size=(b, h, w, f)).astype(np.float32),
    )


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [3, 4])
def test_convlstm_scan_vjp_matches_pallas(k, cdt):
    d = _inputs(seed=k + len(cdt), k=k)
    jdt, tdt = _JDT[cdt], _TDT[cdt]

    def f(xconv, h0, c0, rk, bias):
        y, (h, c) = convlstm_scan_pallas(xconv, h0, c0, rk, bias)
        return y.astype(jnp.float32), h, c

    prim = (jnp.asarray(d["xconv"], jdt), *(jnp.asarray(d[n]) for n in ("h0", "c0", "rk", "bias")))
    (y_j, h_j, c_j), vjp = jax.vjp(f, *prim)
    grads_j = vjp((jnp.asarray(d["dy"]).astype(jdt).astype(jnp.float32), jnp.asarray(d["dh"]),
                   jnp.asarray(d["dc"])))

    leaves = [torch.tensor(d["xconv"]).to(tdt)] + [torch.tensor(d[n]) for n in ("h0", "c0", "rk", "bias")]
    for x in leaves:
        x.requires_grad_(True)
    y_t, h_t, c_t = ConvLstmScan.apply(*leaves)
    assert y_t.dtype == tdt
    torch.autograd.backward(
        (y_t, h_t, c_t), (torch.tensor(d["dy"]).to(tdt), torch.tensor(d["dh"]), torch.tensor(d["dc"]))
    )
    fwd_tol, rel = TOL[cdt]
    for got, want in ((y_t, y_j), (h_t, h_j), (c_t, c_j)):
        np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32), rtol=0, atol=fwd_tol)
    for name, x, want in zip(("dx", "dh0", "dc0", "drk", "db"), leaves, grads_j):
        want = np.asarray(want, np.float32)
        assert x.grad.dtype == x.dtype, name
        np.testing.assert_allclose(
            x.grad.float().numpy(), want, rtol=0, atol=rel * np.abs(want).max(), err_msg=name
        )


@pytest.mark.parametrize("k", [3, 4])
def test_bwd_reference_matches_autograd_through_the_plain_loop(k):
    """No JAX: the plain adjoint == autograd through the plain forward, f32
    at 1e-5 of each gradient's largest entry; the c stack is the loop's c."""
    d = _inputs(seed=11, k=k, t=4)
    leaves = [torch.tensor(d[n], requires_grad=True) for n in ("xconv", "h0", "c0", "rk", "bias")]
    y, cs, h, c = convlstm_fwd_reference(*leaves)
    assert torch.equal(cs[:, -1], c)
    dy, dh, dc = (torch.tensor(d[n]) for n in ("dy", "dh", "dc"))
    torch.autograd.backward((y, h, c), (dy, dh, dc))
    with torch.no_grad():
        got = convlstm_bwd_reference(*(x.detach() for x in leaves), y, cs, dy, dh, dc)
    for name, g, x in zip(("dx", "dh0", "dc0", "drk", "db"), got, leaves):
        scale = float(x.grad.abs().max())
        torch.testing.assert_close(g, x.grad, rtol=0, atol=1e-5 * scale, msg=name)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [3, 4])
def test_bwd_from_the_gate_stack_matches_the_reference(k, cdt, masked):
    """No JAX: the plain forward's gate stack (``with_c_stack``) holds
    each step's pre-activations with gate g of channel j at 4j + g, which
    give back its c stack and y; ``convlstm_bwd`` on that stack gives
    ``convlstm_bwd_reference``'s outputs, which recompute the gates: to
    the bit without masks (the same convs on the same operands), else
    within the module's tolerances (the reference's one block-diagonal
    conv sums in another order than the forward's four)."""
    d = _inputs(seed=3 * k + len(cdt), k=k, t=4)
    tdt = _TDT[cdt]
    args = [torch.tensor(d["xconv"]).to(tdt)] + [torch.tensor(d[n]) for n in ("h0", "c0", "rk", "bias")]
    b, t, h, w, f4 = args[0].shape
    masks = None
    if masked:
        masks = (torch.rand(4, b, h, w, f4 // 4, generator=torch.Generator().manual_seed(k)) < 0.7).float() / 0.7
    stacks = convlstm_fwd.gate_stacks
    y, cs, h_n, c_n, gates, *hm = convlstm_fwd(*args, with_c_stack=True, rec_masks=masks)
    assert convlstm_fwd.gate_stacks == stacks + 1
    assert gates.shape == (b, t, h, w, f4) and gates.dtype == torch.float32
    zi, zf, zc, zo = gates.unflatten(-1, (-1, 4)).unbind(-1)
    c = torch.sigmoid(zf) * torch.cat([args[2][:, None], cs[:, :-1]], 1) + torch.sigmoid(zi) * torch.tanh(zc)
    torch.testing.assert_close(c, cs, rtol=0, atol=1e-6)
    torch.testing.assert_close((torch.sigmoid(zo) * torch.tanh(c)).to(tdt), y, rtol=0, atol=TOL[cdt][0])
    cot = (torch.tensor(d["dy"]).to(tdt), torch.tensor(d["dh"]), torch.tensor(d["dc"]))
    hm = hm[0] if masked else None
    got = convlstm_bwd(gates, *args[1:4], y, cs, *cot, rec_masks=masks, hm=hm)
    want = convlstm_bwd_reference(*args, y, cs, *cot, rec_masks=masks, hm=hm)
    for name, g, r in zip(("dx", "dh0", "dc0", "drk", "db"), got, want):
        assert g.dtype == r.dtype, name
        if masked:
            atol = (1e-5 if cdt == "float32" else TOL[cdt][1]) * float(r.float().abs().max())
            torch.testing.assert_close(g, r, rtol=0, atol=atol, msg=name)
        else:
            assert torch.equal(g, r), name


def test_layer_engines_agree_and_cpu_launches_nothing():
    """``ConvLSTM2D(plain=False)`` (ConvLstmScan on the CPU) and
    ``plain=True`` (autograd through the loop) give the same output and
    gradients, f32 at 1e-6, and no kernel is launched."""
    x = torch.randn(2, 3, 6, 6, 2, generator=torch.Generator().manual_seed(0))
    counts = (convlstm_fwd.launches, convlstm_bwd.launches)
    outs = []
    for plain in (False, True):
        m = layers.ConvLSTM2D(2, 3, (4, 4), strides=(2, 2), plain=plain)
        m.reset_parameters(torch.Generator().manual_seed(1))
        xx = x.clone().requires_grad_(True)
        y, (h, c) = m(xx)
        (y.sin().sum() + (h * c).sum()).backward()
        outs.append((y.detach(), xx.grad, m.recurrent_kernel.grad, m.bias.grad, m.kernel.grad))
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    assert (convlstm_fwd.launches, convlstm_bwd.launches) == counts
    args = [torch.zeros(1, 1, 2, 2, 4, device="meta"), *(torch.zeros(1, 2, 2, 1) for _ in range(2)),
            torch.zeros(1, 1, 1, 4)]
    with pytest.raises(ValueError, match="devices"):
        convlstm_bwd(*args, torch.zeros(1, 1, 2, 2, 1), torch.zeros(1, 1, 2, 2, 1),
                     torch.zeros(1, 1, 2, 2, 1), args[1], args[2])
