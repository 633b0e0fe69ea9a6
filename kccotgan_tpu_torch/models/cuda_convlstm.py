"""ConvLSTM recurrence: the Hopper kernels' wrappers and their plain versions.

Counterpart of ``kccotgan_tpu/models/pallas_convlstm.py``
(``convlstm_scan_pallas`` and its VJP).  ``convlstm_scan`` takes the
hoisted input-conv stack ``xconv [B, T, H', W', 4f]`` in the compute
dtype, the f32 carry ``(h0, c0) [B, H', W', f]``, the recurrent kernel
``[kh, kw, f, 4f]`` and the f32 bias ``[4f]``, and returns
``(y [B, T, H', W', f] in the compute dtype, (h_n, c_n) f32)``.

Per step: the stride-1 'SAME' conv of ``h_{t-1}`` with the recurrent
kernel, both cast to the compute dtype, accumulated in f32 and rounded
once to the compute dtype and back; then ``(x_t + bias) + rconv`` in f32
and the Keras gates [i, f, c, o] (sigmoid / tanh).

Gradients: when autograd needs one, ``convlstm_scan`` runs
``ConvLstmScan``, whose forward also keeps the f32 c stack and whose
backward is the reverse-time adjoint of ``_bwd_kernel``
(``convlstm_bwd``): gates recomputed from ``y[t-1]`` (or ``h0``) and the
c stack, ``dx = cdt(dz)``, ``db`` summed from the f32 ``dz``,
``dh_{t-1}`` the transposed conv of ``cdt(dz)`` kept in f32, and ``drk``
the sum of ``cdt(h_{t-1})^T cdt(dz)`` over steps, samples and pixels.

Dispatch: CPU tensors run the plain versions (``convlstm_fwd_reference``,
``convlstm_bwd_reference``); CUDA tensors launch ``csrc/convlstm_fwd.cu``
once per time step and ``csrc/convlstm_bwd.cu`` twice per step plus twice
for the weight gradient (or raise).  Each wrapper counts its calls in
``.calls`` and its kernel launches in ``.launches``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .conv import same_conv

__all__ = [
    "ConvLstmScan",
    "convlstm_bwd",
    "convlstm_bwd_reference",
    "convlstm_fwd",
    "convlstm_fwd_reference",
    "convlstm_scan",
    "convlstm_scan_reference",
]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _same_pads(k: int) -> tuple[int, int]:
    lo = (k - 1) // 2
    return lo, k - 1 - lo


def convlstm_fwd_reference(xconv, h0, c0, rec_kernel, bias):
    """Plain PyTorch recurrence: ``(y, c_stack, h_n, c_n)``, the kernel's
    oracle and the CPU path."""
    cdt = xconv.dtype
    f = h0.shape[-1]
    h, c = h0, c0
    ys, cs = [], []
    for t in range(xconv.shape[1]):
        rconv = same_conv(h, rec_kernel, (1, 1), cdt, out_dtype=cdt).float()
        z = (xconv[:, t].float() + bias) + rconv
        i = torch.sigmoid(z[..., :f])
        fg = torch.sigmoid(z[..., f : 2 * f])
        c = fg * c + i * torch.tanh(z[..., 2 * f : 3 * f])
        h = torch.sigmoid(z[..., 3 * f :]) * torch.tanh(c)
        ys.append(h.to(cdt))
        cs.append(c)
    return torch.stack(ys, dim=1), torch.stack(cs, dim=1), h, c


def convlstm_scan_reference(xconv, h0, c0, rec_kernel, bias):
    """``(y, (h_n, c_n))`` of the plain recurrence; autograd differentiates
    it (the training step's recurrence under ``kernel_impl='scan'``)."""
    y, _, h, c = convlstm_fwd_reference(xconv, h0, c0, rec_kernel, bias)
    return y, (h, c)


def _shifted(hp, kh, kw):
    """The kh*kw shifted [B, H, W, f] windows of ``hp`` under 'SAME' pads."""
    (lh, hh), (lw, hw) = _same_pads(kh), _same_pads(kw)
    ho, wo = hp.shape[1], hp.shape[2]
    padded = F.pad(hp, (0, 0, lw, hw, lh, hh))
    return [[padded[:, ky : ky + ho, kx : kx + wo] for kx in range(kw)] for ky in range(kh)]


def convlstm_bwd_reference(xconv, h0, c0, rec_kernel, bias, y, c_stack, dy, dh_n, dc_n):
    """Plain port of ``_bwd_kernel``: ``(dx, dh0, dc0, drk, db)``.

    ``dy`` is in the compute dtype; the products of compute-dtype values
    are summed in f32 (the kernel's ``preferred_element_type``), and only
    the recomputed recurrent conv is rounded to the compute dtype."""
    cdt = xconv.dtype
    b, t_total, ho, wo, f4 = xconv.shape
    f = f4 // 4
    kh, kw = rec_kernel.shape[0], rec_kernel.shape[1]
    rk = rec_kernel.to(cdt).float()
    dh, dc = dh_n.float(), dc_n.float()
    dx = torch.empty_like(xconv)
    drk = torch.zeros(kh, kw, f, f4, dtype=torch.float32, device=xconv.device)
    db = torch.zeros(f4, dtype=torch.float32, device=xconv.device)
    # dh_prev: correlate dz with the flipped kernel, pads (hi, lo) swapped
    w_t = torch.flip(rk, (0, 1)).permute(2, 3, 0, 1)  # [f, 4f, kh, kw]
    (lh, hh), (lw, hw) = _same_pads(kh), _same_pads(kw)
    for t in reversed(range(t_total)):
        h_prev = h0 if t == 0 else y[:, t - 1].float()
        c_prev = c0 if t == 0 else c_stack[:, t - 1]
        hp = h_prev.to(cdt)
        rconv = same_conv(hp, rec_kernel, (1, 1), cdt, out_dtype=cdt).float()
        z = (xconv[:, t].float() + bias) + rconv
        i = torch.sigmoid(z[..., :f])
        fg = torch.sigmoid(z[..., f : 2 * f])
        g = torch.tanh(z[..., 2 * f : 3 * f])
        o = torch.sigmoid(z[..., 3 * f :])
        tc = torch.tanh(fg * c_prev + i * g)
        dh = dh + dy[:, t].float()
        dc = dc + dh * o * (1.0 - tc * tc)
        dz = torch.cat(
            [(dc * g) * i * (1.0 - i), (dc * c_prev) * fg * (1.0 - fg),
             (dc * i) * (1.0 - g * g), (dh * tc) * o * (1.0 - o)], dim=-1,
        )
        dx[:, t] = dz.to(cdt)
        db += dz.sum(dim=(0, 1, 2))
        dzc = dz.to(cdt).float()
        dzp = F.pad(dzc.permute(0, 3, 1, 2), (hw, lw, hh, lh))
        dh = F.conv2d(dzp, w_t).permute(0, 2, 3, 1)
        hpf = hp.float()
        for ky, row in enumerate(_shifted(hpf, kh, kw)):
            for kx, sl in enumerate(row):
                drk[ky, kx] += sl.reshape(-1, f).T @ dzc.reshape(-1, f4)
        dc = dc * fg
    return dx, dh, dc, drk, db


def _check(name, t, shape, dtype, device, what="convlstm"):
    """Raise unless ``t`` is what a kernel takes (shared with ``cuda_lstm``)."""
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"{what}: {name} is {t.dtype}, expected {dtype}")
    if t.device != device:
        raise ValueError(f"{what}: {name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: {name} must be contiguous")


def _raise_on(lib, err, what):
    if err:
        raise RuntimeError(f"{what} launch failed: {lib.kccot_error_string(err).decode()}")


def _geometry(xconv, h0, c0, rec_kernel, bias):
    """Checks the forward's inputs; returns ``(b, t, ho, wo, f, kh, kw)``."""
    if xconv.dtype not in _DTYPE_CODES:
        raise TypeError(f"convlstm: unsupported compute dtype {xconv.dtype}")
    if xconv.dim() != 5 or xconv.shape[-1] % 4:
        raise ValueError(f"convlstm: xconv must be [B, T, H, W, 4f], got {tuple(xconv.shape)}")
    b, t, ho, wo, f4 = xconv.shape
    f = f4 // 4
    kh, kw = rec_kernel.shape[0], rec_kernel.shape[1]
    dev = xconv.device
    _check("xconv", xconv, (b, t, ho, wo, f4), xconv.dtype, dev)
    _check("h0", h0, (b, ho, wo, f), torch.float32, dev)
    _check("c0", c0, (b, ho, wo, f), torch.float32, dev)
    _check("rec_kernel", rec_kernel, (kh, kw, f, f4), None, dev)
    _check("bias", bias, (f4,), torch.float32, dev)
    return b, t, ho, wo, f, kh, kw


def _rk4(rec_kernel, cdt):
    """Rounded to the compute dtype, held as f32, the four gates of each
    (ci, j) side by side: [kh, kw, f, f, 4], one 16-byte load a weight."""
    kh, kw, f, f4 = rec_kernel.shape
    return (
        rec_kernel.detach().to(cdt).float()
        .reshape(kh, kw, f, 4, f).transpose(3, 4).contiguous()
    )


def _launch_fwd(xconv, h0, c0, rec_kernel, bias, with_c_stack):
    from .._build import load_library

    b, t, ho, wo, f, kh, kw = _geometry(xconv, h0, c0, rec_kernel, bias)
    cdt, dev = xconv.dtype, xconv.device
    rk4 = _rk4(rec_kernel, cdt)
    lib = load_library()
    y = torch.empty(b, t, ho, wo, f, dtype=cdt, device=dev)
    cs = torch.empty(b, t, ho, wo, f, dtype=torch.float32, device=dev) if with_c_stack else None
    # h is read through the conv halo, so it is double-buffered; c is too,
    # so that the caller's (h0, c0) are never written.
    hbuf = [torch.empty_like(h0), torch.empty_like(h0)]
    cbuf = [torch.empty_like(c0), torch.empty_like(c0)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    isz, hw = xconv.element_size(), ho * wo
    x_bstride, y_bstride = t * hw * 4 * f, t * hw * f
    h_prev, c_prev = h0, c0
    convlstm_fwd.calls += 1
    for s in range(t):
        h_next, c_next = hbuf[s % 2], cbuf[s % 2]
        err = lib.kccot_convlstm_fwd_step(
            _DTYPE_CODES[cdt],
            xconv.data_ptr() + s * hw * 4 * f * isz, x_bstride,
            h_prev.data_ptr(), c_prev.data_ptr(),
            rk4.data_ptr(), bias.data_ptr(),
            h_next.data_ptr(), c_next.data_ptr(),
            y.data_ptr() + s * hw * f * isz, y_bstride,
            cs.data_ptr() + s * hw * f * 4 if cs is not None else None, y_bstride,
            b, ho, wo, f, kh, kw, stream,
        )
        _raise_on(lib, err, "convlstm_fwd")
        convlstm_fwd.launches += 1
        h_prev, c_prev = h_next, c_next
    return y, cs, h_prev, c_prev


def convlstm_fwd(xconv, h0, c0, rec_kernel, bias, with_c_stack=False):
    """``(y, c_stack or None, h_n, c_n)``: the plain version for CPU
    tensors, the forward kernel (one launch a step) for CUDA tensors."""
    devices = {x.device.type for x in (xconv, h0, c0, rec_kernel, bias)}
    if devices == {"cpu"}:
        y, cs, h, c = convlstm_fwd_reference(xconv, h0, c0, rec_kernel, bias)
        return y, cs if with_c_stack else None, h, c
    if devices == {"cuda"}:
        return _launch_fwd(xconv, h0, c0, rec_kernel, bias, with_c_stack)
    raise ValueError(f"convlstm: inputs on devices {sorted(devices)}")


def recurrent_wgrad(lib, y, h0c, dx, dbpart, kh, kw):
    """``(drk [kh, kw, f, 4f], db [4f])`` by ``kccot_recurrent_wgrad``
    (two launches): ``y [B, T, H, W, f]`` and ``h0c`` give ``cdt(h_{t-1})``,
    ``dx [B, T, H, W, 4f]`` is ``cdt(dz)``, ``dbpart [rows, 4f]`` the f32
    partial sums of dz.  Shared with the dense LSTM (H = W = kh = kw = 1)."""
    b, t, ho, wo, f = y.shape
    f4, m = 4 * f, kh * kw * f
    pixels = b * t * ho * wo
    tiles = -(-m // 64) * -(-f4 // 64)
    # split the B*T*H*W sum until about 4 blocks per SM of 132 are in
    # flight, but keep at least 256 pixels a split
    splits = max(1, min(-(-528 // tiles), pixels // 256))
    chunk = -(-pixels // splits)
    dev = y.device
    part = torch.empty(splits, m, f4, dtype=torch.float32, device=dev)
    drk = torch.empty(kh, kw, f, f4, dtype=torch.float32, device=dev)
    db = torch.empty(f4, dtype=torch.float32, device=dev)
    err = lib.kccot_recurrent_wgrad(
        _DTYPE_CODES[y.dtype], y.data_ptr(), h0c.data_ptr(), dx.data_ptr(), part.data_ptr(),
        splits, chunk, dbpart.data_ptr(), dbpart.shape[0], drk.data_ptr(), db.data_ptr(),
        b, t, ho, wo, f, kh, kw, torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(lib, err, "recurrent_wgrad")
    return drk, db


def _launch_bwd(xconv, h0, c0, rec_kernel, bias, y, c_stack, dy, dh_n, dc_n):
    from .._build import load_library

    b, t, ho, wo, f, kh, kw = _geometry(xconv, h0, c0, rec_kernel, bias)
    cdt, dev = xconv.dtype, xconv.device
    for name, x, dtype in (("y", y, cdt), ("c_stack", c_stack, torch.float32), ("dy", dy, cdt)):
        _check(name, x, (b, t, ho, wo, f), dtype, dev)
    _check("dh_n", dh_n, (b, ho, wo, f), torch.float32, dev)
    _check("dc_n", dc_n, (b, ho, wo, f), torch.float32, dev)
    f4 = 4 * f
    rk4 = _rk4(rec_kernel, cdt)
    # [kh, kw, 4f/4, f, 4]: four consecutive output channels n of one ci
    rkT4 = (
        rec_kernel.detach().to(cdt).float()
        .reshape(kh, kw, f, f4 // 4, 4).permute(0, 1, 3, 2, 4).contiguous()
    )
    h0c = h0.to(cdt)  # h_{-1} as the kernels read y: rounded to the compute dtype
    lib = load_library()
    dh, dc = dh_n.clone(), dc_n.clone()
    dx = torch.empty_like(xconv)
    dbpart = torch.zeros(lib.kccot_convlstm_bwd_rows(b, ho, wo, f), f4, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code, isz, hw = _DTYPE_CODES[cdt], xconv.element_size(), ho * wo
    x_bs, y_bs = t * hw * f4, t * hw * f
    convlstm_bwd.calls += 1
    for s in reversed(range(t)):
        if s:
            hp, hp_bs = y.data_ptr() + (s - 1) * hw * f * isz, y_bs
            cp, cp_bs = c_stack.data_ptr() + (s - 1) * hw * f * 4, y_bs
        else:
            hp, hp_bs, cp, cp_bs = h0c.data_ptr(), hw * f, c0.data_ptr(), hw * f
        dx_t = dx.data_ptr() + s * hw * f4 * isz
        err = lib.kccot_convlstm_bwd_step(
            code, xconv.data_ptr() + s * hw * f4 * isz, x_bs, hp, hp_bs, cp, cp_bs,
            rk4.data_ptr(), bias.data_ptr(), dy.data_ptr() + s * hw * f * isz, y_bs,
            dh.data_ptr(), dc.data_ptr(), dx_t, x_bs, dbpart.data_ptr(),
            b, ho, wo, f, kh, kw, stream,
        )
        _raise_on(lib, err, "convlstm_bwd step")
        err = lib.kccot_convlstm_bwd_dh(
            code, dx_t, x_bs, rkT4.data_ptr(), dh.data_ptr(), b, ho, wo, f, kh, kw, stream
        )
        _raise_on(lib, err, "convlstm_bwd dh")
        convlstm_bwd.launches += 2
    drk, db = recurrent_wgrad(lib, y, h0c, dx, dbpart, kh, kw)
    convlstm_bwd.launches += 2
    return dx, dh, dc, drk, db


def convlstm_bwd(xconv, h0, c0, rec_kernel, bias, y, c_stack, dy, dh_n, dc_n):
    """``(dx, dh0, dc0, drk, db)`` of the recurrence: the plain version for
    CPU tensors, the backward kernels for CUDA tensors."""
    args = (xconv, h0, c0, rec_kernel, bias, y, c_stack, dy, dh_n, dc_n)
    devices = {x.device.type for x in args}
    if devices == {"cpu"}:
        return convlstm_bwd_reference(*args)
    if devices == {"cuda"}:
        return _launch_bwd(*args)
    raise ValueError(f"convlstm: inputs on devices {sorted(devices)}")


for _fn in (convlstm_fwd, convlstm_bwd):
    _fn.calls = _fn.launches = 0


class ConvLstmScan(torch.autograd.Function):
    """The recurrence under autograd: saves ``(xconv, h0, c0, rec_kernel,
    bias, y, c_stack)`` as ``_vjp_fwd`` does; unused ``(h_n, c_n)`` count
    as zero cotangents."""

    @staticmethod
    def forward(ctx, xconv, h0, c0, rec_kernel, bias):
        y, cs, h, c = convlstm_fwd(xconv, h0, c0, rec_kernel, bias, with_c_stack=True)
        ctx.save_for_backward(xconv, h0, c0, rec_kernel, bias, y, cs)
        return y, h, c

    @staticmethod
    def backward(ctx, dy, dh_n, dc_n):
        xconv, h0, c0, rec_kernel, bias, y, cs = ctx.saved_tensors
        dx, dh0, dc0, drk, db = convlstm_bwd(
            xconv, h0, c0, rec_kernel, bias, y, cs,
            dy.to(xconv.dtype).contiguous(), dh_n.float().contiguous(), dc_n.float().contiguous(),
        )
        return dx, dh0, dc0, drk.to(rec_kernel.dtype), db.to(bias.dtype)


def convlstm_scan(xconv, h0, c0, rec_kernel, bias):
    """The fused ConvLSTM recurrence (contract in the module docstring):
    ``ConvLstmScan`` when autograd needs a gradient, else the forward
    alone.  CPU tensors take the plain versions, CUDA tensors the kernels;
    anything the kernels do not take raises."""
    args = (xconv, h0, c0, rec_kernel, bias)
    if torch.is_grad_enabled() and any(x.requires_grad for x in args):
        y, h, c = ConvLstmScan.apply(*args)
        return y, (h, c)
    y, _, h, c = convlstm_fwd(*args)
    return y, (h, c)
