"""Dense LSTM recurrence: the Hopper kernels' wrappers and their plain versions.

Counterpart of ``kccotgan_tpu/models/pallas_lstm.py`` (``lstm_scan_pallas``
and its VJP).  ``lstm_scan`` takes the hoisted input projection ``xproj
[B, T, 4U]`` in the compute dtype, the f32 carry ``(h0, c0) [B, U]``, the
recurrent kernel ``[U, 4U]``, the f32 bias ``[4U]`` and the output
activation (``'tanh'``, or ``'sigmoid'`` for the discriminator's last
layer; the recurrent activation is sigmoid), and returns ``(y [B, T, U]
in the compute dtype, (h_n, c_n) f32)``.

Per step: ``cdt(h) @ cdt(R)`` accumulated in f32 and rounded once to the
compute dtype and back, ``(x_t + b) + rproj`` in f32, the Keras gates
[i, f, c, o].  Gradients (``LstmScan``, when autograd needs one) follow
``_bwd_kernel``: gates recomputed from ``y[t-1]`` (or ``h0``) and the
saved c stack, ``dx = cdt(dz)``, ``db`` summed from the f32 ``dz``,
``dh_{t-1} = cdt(dz) @ cdt(R)^T`` in f32, ``dR`` the sum of
``cdt(h_{t-1})^T cdt(dz)``.

Dispatch: CPU tensors run the plain versions (``lstm_scan_reference``,
``lstm_bwd_reference``); CUDA tensors launch ``csrc/lstm_fwd.cu`` (one
launch for all T steps) and, backward, ``csrc/lstm_bwd.cu`` and the
weight-gradient sum of ``csrc/convlstm_bwd.cu`` (three launches), or
raise.  Each wrapper counts its calls in ``.calls`` and its kernel
launches in ``.launches``.
"""

from __future__ import annotations

import functools

import torch

from .cuda_convlstm import _DTYPE_CODES, _raise_on, recurrent_wgrad
from .cuda_convlstm import _check as _check_tensor

__all__ = ["LstmScan", "lstm_bwd", "lstm_bwd_reference", "lstm_fwd", "lstm_scan", "lstm_scan_reference"]

_ACT = {"tanh": torch.tanh, "sigmoid": torch.sigmoid}
_ACT_CODES = {"tanh": 0, "sigmoid": 1}


def _dact(name, a):
    """The activation's derivative written on its value ``a``."""
    return 1.0 - a * a if name == "tanh" else a * (1.0 - a)


def lstm_scan_reference(xproj, h0, c0, rec_kernel, bias, activation="tanh"):
    """Plain PyTorch recurrence: ``(y, c_stack, h_n, c_n)``, the kernel's
    oracle and the CPU path; autograd differentiates it under
    ``kernel_impl='scan'``."""
    cdt = xproj.dtype
    u = h0.shape[-1]
    act = _ACT[activation]
    rk = rec_kernel.to(cdt)
    h, c = h0, c0
    ys, cs = [], []
    for t in range(xproj.shape[1]):
        z = (xproj[:, t].float() + bias) + (h.to(cdt) @ rk).float()
        i = torch.sigmoid(z[:, :u])
        fg = torch.sigmoid(z[:, u : 2 * u])
        c = fg * c + i * act(z[:, 2 * u : 3 * u])
        h = torch.sigmoid(z[:, 3 * u :]) * act(c)
        ys.append(h.to(cdt))
        cs.append(c)
    return torch.stack(ys, dim=1), torch.stack(cs, dim=1), h, c


def lstm_bwd_reference(xproj, h0, c0, rec_kernel, bias, y, c_stack, dy, dh_n, dc_n,
                       activation="tanh"):
    """Line-by-line plain port of ``_bwd_kernel``: ``(dx, dh0, dc0, dR,
    db)``.  ``dy`` is in the compute dtype."""
    cdt = xproj.dtype
    u = h0.shape[-1]
    act = _ACT[activation]
    rk = rec_kernel.to(cdt)
    rkf = rk.float()
    dh, dc = dh_n.float(), dc_n.float()
    dx = torch.empty_like(xproj)
    drk = torch.zeros(u, 4 * u, dtype=torch.float32, device=xproj.device)
    db = torch.zeros(4 * u, dtype=torch.float32, device=xproj.device)
    for t in reversed(range(xproj.shape[1])):
        h_prev = h0 if t == 0 else y[:, t - 1].float()
        c_prev = c0 if t == 0 else c_stack[:, t - 1]
        hp = h_prev.to(cdt)
        z = (xproj[:, t].float() + bias) + (hp @ rk).float()
        i = torch.sigmoid(z[:, :u])
        fg = torch.sigmoid(z[:, u : 2 * u])
        g = act(z[:, 2 * u : 3 * u])
        o = torch.sigmoid(z[:, 3 * u :])
        tc = act(fg * c_prev + i * g)
        dh = dh + dy[:, t].float()
        dc = dc + dh * o * _dact(activation, tc)
        dz = torch.cat(
            [(dc * g) * i * (1.0 - i), (dc * c_prev) * fg * (1.0 - fg),
             (dc * i) * _dact(activation, g), (dh * tc) * o * (1.0 - o)], dim=-1,
        )
        dx[:, t] = dz.to(cdt)
        db += dz.sum(dim=0)
        dzc = dz.to(cdt).float()
        drk += hp.float().T @ dzc
        dh = dzc @ rkf.T
        dc = dc * fg
    return dx, dh, dc, drk, db


_check = functools.partial(_check_tensor, what="lstm")


def _geometry(xproj, h0, c0, rec_kernel, bias, activation):
    if xproj.dtype not in _DTYPE_CODES:
        raise TypeError(f"lstm: unsupported compute dtype {xproj.dtype}")
    if activation not in _ACT_CODES:
        raise ValueError(f"lstm: unsupported activation {activation!r}")
    if xproj.dim() != 3 or xproj.shape[-1] % 4:
        raise ValueError(f"lstm: xproj must be [B, T, 4U], got {tuple(xproj.shape)}")
    b, t, u4 = xproj.shape
    u, dev = u4 // 4, xproj.device
    _check("xproj", xproj, (b, t, u4), xproj.dtype, dev)
    _check("h0", h0, (b, u), torch.float32, dev)
    _check("c0", c0, (b, u), torch.float32, dev)
    _check("rec_kernel", rec_kernel, (u, u4), None, dev)
    _check("bias", bias, (u4,), torch.float32, dev)
    return b, t, u


def _launch_fwd(xproj, h0, c0, rec_kernel, bias, activation, with_c_stack):
    from .._build import load_library

    b, t, u = _geometry(xproj, h0, c0, rec_kernel, bias, activation)
    cdt, dev = xproj.dtype, xproj.device
    r = rec_kernel.detach().to(cdt).float().contiguous()
    lib = load_library()
    y = torch.empty(b, t, u, dtype=cdt, device=dev)
    cs = torch.empty(b, t, u, dtype=torch.float32, device=dev) if with_c_stack else None
    hn, cn = torch.empty_like(h0), torch.empty_like(c0)
    lstm_fwd.calls += 1
    err = lib.kccot_lstm_fwd(
        _DTYPE_CODES[cdt], _ACT_CODES[activation], xproj.data_ptr(), h0.data_ptr(),
        c0.data_ptr(), r.data_ptr(), bias.data_ptr(), y.data_ptr(),
        cs.data_ptr() if cs is not None else None, hn.data_ptr(), cn.data_ptr(), b, t, u,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(lib, err, "lstm_fwd")
    lstm_fwd.launches += 1
    return y, cs, hn, cn


def lstm_fwd(xproj, h0, c0, rec_kernel, bias, activation="tanh", with_c_stack=False):
    """``(y, c_stack or None, h_n, c_n)``: the plain version for CPU
    tensors, the forward kernel for CUDA tensors."""
    devices = {x.device.type for x in (xproj, h0, c0, rec_kernel, bias)}
    if devices == {"cpu"}:
        y, cs, h, c = lstm_scan_reference(xproj, h0, c0, rec_kernel, bias, activation)
        return y, cs if with_c_stack else None, h, c
    if devices == {"cuda"}:
        return _launch_fwd(xproj, h0, c0, rec_kernel, bias, activation, with_c_stack)
    raise ValueError(f"lstm: inputs on devices {sorted(devices)}")


def _launch_bwd(xproj, h0, c0, rec_kernel, bias, y, c_stack, dy, dh_n, dc_n, activation):
    from .._build import load_library

    b, t, u = _geometry(xproj, h0, c0, rec_kernel, bias, activation)
    cdt, dev = xproj.dtype, xproj.device
    for name, x, dtype in (("y", y, cdt), ("c_stack", c_stack, torch.float32), ("dy", dy, cdt)):
        _check(name, x, (b, t, u), dtype, dev)
    _check("dh_n", dh_n, (b, u), torch.float32, dev)
    _check("dc_n", dc_n, (b, u), torch.float32, dev)
    r = rec_kernel.detach().to(cdt).float().contiguous()
    lib = load_library()
    dx = torch.empty_like(xproj)
    dh0, dc0 = torch.empty_like(h0), torch.empty_like(c0)
    dbpart = torch.empty(b, 4 * u, dtype=torch.float32, device=dev)
    lstm_bwd.calls += 1
    err = lib.kccot_lstm_bwd(
        _DTYPE_CODES[cdt], _ACT_CODES[activation], xproj.data_ptr(), y.data_ptr(),
        c_stack.data_ptr(), h0.data_ptr(), c0.data_ptr(), r.data_ptr(), bias.data_ptr(),
        dy.data_ptr(), dh_n.data_ptr(), dc_n.data_ptr(), dx.data_ptr(), dh0.data_ptr(),
        dc0.data_ptr(), dbpart.data_ptr(), b, t, u, torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(lib, err, "lstm_bwd")
    lstm_bwd.launches += 1
    # dR and db: the ConvLSTM's weight-gradient sum on a 1x1 frame and kernel
    drk, db = recurrent_wgrad(
        lib, y.view(b, t, 1, 1, u), h0.to(cdt), dx.view(b, t, 1, 1, 4 * u), dbpart, 1, 1
    )
    lstm_bwd.launches += 2
    return dx, dh0, dc0, drk.view(u, 4 * u), db


def lstm_bwd(xproj, h0, c0, rec_kernel, bias, y, c_stack, dy, dh_n, dc_n, activation="tanh"):
    """``(dx, dh0, dc0, dR, db)``: the plain version for CPU tensors, the
    backward kernels for CUDA tensors."""
    args = (xproj, h0, c0, rec_kernel, bias, y, c_stack, dy, dh_n, dc_n)
    devices = {x.device.type for x in args}
    if devices == {"cpu"}:
        return lstm_bwd_reference(*args, activation)
    if devices == {"cuda"}:
        return _launch_bwd(*args, activation)
    raise ValueError(f"lstm: inputs on devices {sorted(devices)}")


for _fn in (lstm_fwd, lstm_bwd):
    _fn.calls = _fn.launches = 0


class LstmScan(torch.autograd.Function):
    """The recurrence under autograd: saves ``(xproj, h0, c0, rec_kernel,
    bias, y, c_stack)`` as ``_vjp_fwd`` does; unused ``(h_n, c_n)`` count
    as zero cotangents."""

    @staticmethod
    def forward(ctx, xproj, h0, c0, rec_kernel, bias, activation):
        y, cs, h, c = lstm_fwd(xproj, h0, c0, rec_kernel, bias, activation, with_c_stack=True)
        ctx.activation = activation
        ctx.save_for_backward(xproj, h0, c0, rec_kernel, bias, y, cs)
        return y, h, c

    @staticmethod
    def backward(ctx, dy, dh_n, dc_n):
        xproj, h0, c0, rec_kernel, bias, y, cs = ctx.saved_tensors
        dx, dh0, dc0, drk, db = lstm_bwd(
            xproj, h0, c0, rec_kernel, bias, y, cs, dy.to(xproj.dtype).contiguous(),
            dh_n.float().contiguous(), dc_n.float().contiguous(), ctx.activation,
        )
        return dx, dh0, dc0, drk.to(rec_kernel.dtype), db.to(bias.dtype), None


def lstm_scan(xproj, h0, c0, rec_kernel, bias, activation="tanh"):
    """The fused LSTM recurrence (contract in the module docstring):
    ``LstmScan`` when autograd needs a gradient, else the forward alone."""
    args = (xproj, h0, c0, rec_kernel, bias)
    if torch.is_grad_enabled() and any(x.requires_grad for x in args):
        y, h, c = LstmScan.apply(*args, activation)
        return y, (h, c)
    y, _, h, c = lstm_fwd(*args, activation)
    return y, (h, c)
