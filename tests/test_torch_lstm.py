"""The port's dense LSTM recurrence (``models/cuda_lstm.py``) vs the JAX
package's ``lstm_scan_pallas`` and its VJP.

The same seeded numpy inputs go through ``jax.vjp`` of the Pallas
recurrence (interpret mode on the CPU) and through ``LstmScan``, whose
forward and backward on CPU tensors are the kernels' plain versions
(``lstm_scan_reference``, ``lstm_bwd_reference``).  Nonzero h0, c0 and
cotangents of y, h_n and c_n; tanh and sigmoid output activations.

Tolerances: f32 at 1e-5 abs (forward) and 2e-5 of each gradient's
largest entry: the same arithmetic, summed in another order.  bf16 at
one bf16 ulp of y (4e-3 abs) and 2e-2 of each gradient's largest entry:
both sides round h, R, the recurrent product, y and dz to bf16 at the
same points, but another f32 summation order can round one of them one
ulp (2**-8 relative) apart, and the adjoint carries that over the steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kccotgan_tpu.models.pallas_lstm import lstm_scan_pallas
from kccotgan_tpu_torch.models import layers
from kccotgan_tpu_torch.models.cuda_lstm import (
    LstmScan,
    lstm_bwd,
    lstm_bwd_reference,
    lstm_fwd,
    lstm_scan,
    lstm_scan_reference,
)

torch.set_num_threads(1)

_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"float32": (1e-5, 2e-5), "bfloat16": (4e-3, 2e-2)}  # (forward abs, gradient rel)


def _inputs(seed, b=3, t=4, u=5):
    rng = np.random.default_rng(seed)
    return dict(
        xproj=rng.normal(size=(b, t, 4 * u)).astype(np.float32),
        h0=(rng.normal(size=(b, u)) * 0.5).astype(np.float32),
        c0=(rng.normal(size=(b, u)) * 0.5).astype(np.float32),
        rk=(rng.normal(size=(u, 4 * u)) * 0.4).astype(np.float32),
        bias=(rng.normal(size=(4 * u,)) * 0.1).astype(np.float32),
        dy=rng.normal(size=(b, t, u)).astype(np.float32),
        dh=rng.normal(size=(b, u)).astype(np.float32),
        dc=rng.normal(size=(b, u)).astype(np.float32),
    )


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["tanh", "sigmoid"])
def test_lstm_scan_vjp_matches_pallas(act, cdt):
    d = _inputs(seed=len(act) + len(cdt))
    jdt, tdt = _JDT[cdt], _TDT[cdt]

    def f(xproj, h0, c0, rk, bias):
        y, (h, c) = lstm_scan_pallas(xproj, h0, c0, rk, bias, act, "sigmoid")
        return y.astype(jnp.float32), h, c

    prim = (jnp.asarray(d["xproj"], jdt), *(jnp.asarray(d[k]) for k in ("h0", "c0", "rk", "bias")))
    (y_j, h_j, c_j), vjp = jax.vjp(f, *prim)
    grads_j = vjp((jnp.asarray(d["dy"]).astype(jdt).astype(jnp.float32), jnp.asarray(d["dh"]),
                   jnp.asarray(d["dc"])))

    leaves = [torch.tensor(d["xproj"]).to(tdt)] + [torch.tensor(d[k]) for k in ("h0", "c0", "rk", "bias")]
    for x in leaves:
        x.requires_grad_(True)
    y_t, h_t, c_t = LstmScan.apply(*leaves, act)
    assert y_t.dtype == tdt
    torch.autograd.backward(
        (y_t, h_t, c_t), (torch.tensor(d["dy"]).to(tdt), torch.tensor(d["dh"]), torch.tensor(d["dc"]))
    )
    fwd_tol, rel = TOL[cdt]
    for got, want in ((y_t, y_j), (h_t, h_j), (c_t, c_j)):
        np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32), rtol=0, atol=fwd_tol)
    for name, x, want in zip(("dx", "dh0", "dc0", "dR", "db"), leaves, grads_j):
        want = np.asarray(want, np.float32)
        assert x.grad.dtype == x.dtype, name
        np.testing.assert_allclose(
            x.grad.float().numpy(), want, rtol=0, atol=rel * np.abs(want).max(), err_msg=name
        )


@pytest.mark.parametrize("act", ["tanh", "sigmoid"])
def test_bwd_reference_matches_autograd_through_the_plain_loop(act):
    """No JAX: the plain adjoint == autograd through the plain forward, f32
    at 1e-5 of each gradient's largest entry."""
    d = _inputs(seed=7, b=2, t=5, u=3)
    leaves = [torch.tensor(d[k], requires_grad=True) for k in ("xproj", "h0", "c0", "rk", "bias")]
    y, cs, h, c = lstm_scan_reference(*leaves, act)
    dy, dh, dc = (torch.tensor(d[k]) for k in ("dy", "dh", "dc"))
    torch.autograd.backward((y, h, c), (dy, dh, dc))
    with torch.no_grad():
        got = lstm_bwd_reference(*(x.detach() for x in leaves), y, cs, dy, dh, dc, act)
    for name, g, x in zip(("dx", "dh0", "dc0", "dR", "db"), got, leaves):
        scale = float(x.grad.abs().max())
        torch.testing.assert_close(g, x.grad, rtol=0, atol=1e-5 * scale, msg=name)


def test_cpu_dispatch_launches_nothing_and_keeps_the_c_stack():
    d = _inputs(seed=3)
    args = [torch.tensor(d[k]) for k in ("xproj", "h0", "c0", "rk", "bias")]
    counts = (lstm_fwd.launches, lstm_bwd.launches)
    y, cs, h, c = lstm_fwd(*args, "tanh", with_c_stack=True)
    want = lstm_scan_reference(*args, "tanh")
    for got, w in zip((y, cs, h, c), want):
        assert torch.equal(got, w)
    assert lstm_fwd(*args, "tanh")[1] is None
    y2, (h2, c2) = lstm_scan(*args, "tanh")  # nothing needs a gradient: forward only
    assert torch.equal(y2, y) and torch.equal(h2, h)
    lstm_bwd(*args, y, cs, y, h, c, "tanh")
    assert (lstm_fwd.launches, lstm_bwd.launches) == counts


def test_layer_engines_agree_and_bad_inputs_raise():
    """``LSTM(plain=False)`` (LstmScan) and ``plain=True`` (autograd through
    the loop) give the same output and gradients, f32 at 1e-6."""
    torch.manual_seed(0)
    x = torch.randn(2, 5, 6)
    outs = []
    for plain in (False, True):
        m = layers.LSTM(6, 4, activation="sigmoid", plain=plain)
        m.reset_parameters(torch.Generator().manual_seed(1))
        xx = x.clone().requires_grad_(True)
        y = m(xx)
        (y * torch.arange(y.numel()).reshape(y.shape).sin()).sum().backward()
        outs.append((y.detach(), xx.grad, m.recurrent_kernel.grad, m.bias.grad, m.kernel.grad))
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="activation"):
        layers.LSTM(6, 4, activation="relu")
    args = [torch.zeros(2, 3, 8), torch.zeros(2, 2), torch.zeros(2, 2), torch.zeros(2, 8), torch.zeros(8)]
    with pytest.raises(ValueError, match="devices"):
        lstm_fwd(args[0].to("meta"), *args[1:])
