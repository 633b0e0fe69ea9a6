"""PyTorch port's layers and ConvLSTM recurrence vs the JAX package.

The same seeded numpy inputs and the JAX-initialised weights go through
the JAX function (on the CPU; the Pallas kernel in interpret mode) and
its port (the plain PyTorch version, which CPU tensors dispatch to).

Tolerances: float32 at 1e-5 abs, which covers the two frameworks'
different conv summation orders.  bfloat16 at 4e-3 abs, one bf16 ulp of
y in [0.5, 1): both sides round the convs and y to bf16 once, but a
different f32 summation order can put a rounding one ulp apart, and a
flipped ulp of the recurrent conv moves the gates a little further.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kccotgan_tpu.models import layers as jl
from kccotgan_tpu.models.pallas_convlstm import convlstm_scan_pallas
from kccotgan_tpu_torch.models.cuda_convlstm import convlstm_fwd, convlstm_scan, convlstm_scan_reference
from kccotgan_tpu_torch.models.conv import same_conv
from kccotgan_tpu_torch.models.layers import ConvLSTM2D, ConvTranspose2D

torch.set_num_threads(1)

F32_TOL = 1e-5
BF16_TOL = 4e-3
_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a, np.float32)).to(dtype)


def _np(t):
    return t.float().numpy()


def _load(module, jax_params):
    module.load_state_dict({k: _t(v) for k, v in jax_params.items()})
    return module


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "k,with_bias,with_state",
    [(3, True, False), (4, False, True), (5, True, True), (8, False, False)],
)
def test_scan_reference_matches_pallas(k, with_bias, with_state, cdt):
    """The plain recurrence == convlstm_scan_pallas on the raw stack:
    odd and even (asymmetric 'SAME') kernels, bias or zeros, given or
    zero initial state."""
    rng = np.random.default_rng(k)
    b, t, ho, wo, f = 2, 3, 6, 6, 4
    xconv = rng.normal(size=(b, t, ho, wo, 4 * f)).astype(np.float32)
    rk = (rng.normal(size=(k, k, f, 4 * f)) * 0.2).astype(np.float32)
    bias = rng.normal(size=(4 * f,)).astype(np.float32) if with_bias else np.zeros(4 * f, np.float32)
    h0, c0 = (
        (rng.normal(size=(b, ho, wo, f)) * 0.3).astype(np.float32) for _ in range(2)
    ) if with_state else (np.zeros((b, ho, wo, f), np.float32),) * 2

    y_j, (h_j, c_j) = convlstm_scan_pallas(
        jnp.asarray(xconv, _JDT[cdt]), jnp.asarray(h0), jnp.asarray(c0),
        jnp.asarray(rk), jnp.asarray(bias),
    )
    y_t, (h_t, c_t) = convlstm_scan_reference(
        _t(xconv, _TDT[cdt]), _t(h0), _t(c0), _t(rk), _t(bias)
    )
    assert y_t.dtype == _TDT[cdt] and h_t.dtype == c_t.dtype == torch.float32
    tol = F32_TOL if cdt == "float32" else BF16_TOL
    for got, want in ((y_t, y_j), (h_t, h_j), (c_t, c_j)):
        np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), rtol=0, atol=tol)


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "k,stride,use_bias,with_state",
    [(6, 2, False, False), (5, 2, False, True), (4, 1, False, True), (8, 1, True, False)],
)
def test_convlstm_layer_matches_jax(k, stride, use_bias, with_state, cdt):
    """ConvLSTM2D (hoisted input conv + recurrence) == the JAX layer's
    lax.scan path, stride 1 and 2, even kernels, carry in and out."""
    rng = np.random.default_rng(10 * k + stride)
    b, t, h, w, c, f = 2, 3, 8, 8, 3, 4
    x = (rng.normal(size=(b, t, h, w, c)) * 0.5).astype(np.float32)
    ho = -(-h // stride)
    layer_j = jl.ConvLSTM2D(
        filters=f, kernel_size=(k, k), strides=(stride, stride),
        use_bias=use_bias, compute_dtype=cdt, kernel_impl="scan",
    )
    params = layer_j.init(jax.random.PRNGKey(k), jnp.asarray(x), training=False)
    state_j = state_t = None
    if with_state:
        h0, c0 = ((rng.normal(size=(b, ho, ho, f)) * 0.3).astype(np.float32) for _ in range(2))
        state_j, state_t = (jnp.asarray(h0), jnp.asarray(c0)), (_t(h0), _t(c0))
    y_j, (hn_j, cn_j) = layer_j.apply(
        params, jnp.asarray(x), training=False, initial_state=state_j, return_state=True
    )
    layer_t = _load(
        ConvLSTM2D(c, f, (k, k), (stride, stride), use_bias=use_bias, compute_dtype=cdt),
        params["params"],
    )
    with torch.no_grad():
        y_t, (hn_t, cn_t) = layer_t(_t(x), initial_state=state_t)
    assert y_t.dtype == torch.float32
    tol = F32_TOL if cdt == "float32" else BF16_TOL
    for got, want in ((y_t, y_j), (hn_t, hn_j), (cn_t, cn_j)):
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=tol)


@pytest.mark.parametrize("size,k,stride", [(9, 5, 2), (8, 6, 2), (8, 4, 1), (8, 8, 1), (7, 3, 1)])
def test_same_conv_matches_jax(size, k, stride):
    rng = np.random.default_rng(size * k)
    x = rng.normal(size=(2, size, size, 3)).astype(np.float32)
    kern = rng.normal(size=(k, k, 3, 5)).astype(np.float32)
    want = jl._same_conv(jnp.asarray(x), jnp.asarray(kern), (stride, stride))
    got = same_conv(_t(x), _t(kern), (stride, stride))
    assert got.shape == want.shape == (2, -(-size // stride), -(-size // stride), 5)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=F32_TOL)


@pytest.mark.parametrize(
    "kernel,stride,act",
    [((2, 2), (2, 2), "tanh"), ((4, 4), (2, 2), "tanh"), ((6, 6), (2, 2), "tanh"),
     ((8, 8), (1, 1), "sigmoid"), ((6, 7), (2, 2), "tanh"), ((7, 6), (3, 2), "tanh")],
)
def test_conv_transpose_matches_jax(kernel, stride, act):
    rng = np.random.default_rng(sum(kernel) + sum(stride))
    x = rng.normal(size=(2, 4, 5, 6)).astype(np.float32)
    mod_j = jl.ConvTranspose2D(
        filters=3, kernel_size=kernel, strides=stride, use_bias=False, activation=act
    )
    params = mod_j.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = mod_j.apply(params, jnp.asarray(x))
    mod_t = _load(ConvTranspose2D(6, 3, kernel, stride, activation=act), params["params"])
    with torch.no_grad():
        got = mod_t(_t(x))
    assert got.shape == want.shape == (2, 4 * stride[0], 5 * stride[1], 3)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=F32_TOL)


def test_cpu_tensors_take_plain_path_without_launch():
    rng = np.random.default_rng(0)
    args = [
        _t(rng.normal(size=s)) for s in
        [(1, 2, 4, 4, 8), (1, 4, 4, 2), (1, 4, 4, 2), (3, 3, 2, 8), (8,)]
    ]
    got = convlstm_scan(*args)
    want = convlstm_scan_reference(*args)
    assert convlstm_fwd.launches == 0
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_mixed_devices_raise():
    xconv = torch.zeros(1, 1, 2, 2, 4, device="meta")
    rest = [torch.zeros(1, 2, 2, 1), torch.zeros(1, 2, 2, 1), torch.zeros(1, 1, 1, 4), torch.zeros(4)]
    with pytest.raises(ValueError, match="devices"):
        convlstm_scan(xconv, *rest)


@pytest.mark.parametrize("kw,shape", [
    (dict(dropout=0.3), (2, 8, 8, 3)), (dict(recurrent_dropout=0.3), (2, 4, 4, 4)),
])
def test_dropout_applies_only_in_training(kw, shape):
    """Outside training the layer is its dropout-free twin to the bit; in
    training it draws four masks of the input's (or the recurrent state's)
    shape, with keep probability 1 - p, and the same masks give the same
    output."""
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 3, 8, 8, 3)).astype(np.float32))
    layer = ConvLSTM2D(3, 4, (3, 3), strides=(2, 2), **kw)
    layer.reset_parameters(torch.Generator().manual_seed(0))
    twin = ConvLSTM2D(3, 4, (3, 3), strides=(2, 2))
    twin.load_state_dict(layer.state_dict())
    assert torch.equal(layer(x)[0], twin(x)[0])
    drawn = []

    def masks(keep, mask_shape):
        drawn.append((keep, tuple(mask_shape)))
        g = torch.Generator().manual_seed(len(drawn) % 4)
        return torch.empty(mask_shape).bernoulli_(keep, generator=g)

    a = layer(x, training=True, masks=masks)[0]
    assert drawn == [(0.7, shape)] * 4
    assert torch.equal(layer(x, training=True, masks=masks)[0], a)
    assert not torch.equal(a, twin(x)[0])
