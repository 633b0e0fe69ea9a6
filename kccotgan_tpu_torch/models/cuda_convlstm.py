"""ConvLSTM recurrence: the Hopper kernel's wrapper and its plain version.

Counterpart of ``kccotgan_tpu/models/pallas_convlstm.py``
(``convlstm_scan_pallas``, forward only).  ``convlstm_scan`` takes the
hoisted input-conv stack ``xconv [B, T, H', W', 4f]`` in the compute
dtype, the f32 carry ``(h0, c0) [B, H', W', f]``, the recurrent kernel
``[kh, kw, f, 4f]`` and the f32 bias ``[4f]``, and returns
``(y [B, T, H', W', f] in the compute dtype, (h_n, c_n) f32)``.

Per step: the stride-1 'SAME' conv of ``h_{t-1}`` with the recurrent
kernel, both cast to the compute dtype, accumulated in f32 and rounded
once to the compute dtype and back; then ``(x_t + bias) + rconv`` in f32
and the Keras gates [i, f, c, o] (sigmoid / tanh).

Dispatch: CPU tensors run ``convlstm_scan_reference``; CUDA tensors
launch ``csrc/convlstm_fwd.cu`` once per time step (or raise).
"""

from __future__ import annotations

import torch

from .conv import same_conv

__all__ = ["convlstm_scan", "convlstm_scan_reference"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def convlstm_scan_reference(xconv, h0, c0, rec_kernel, bias):
    """Plain PyTorch recurrence: the kernel's oracle and the CPU path."""
    cdt = xconv.dtype
    f = h0.shape[-1]
    h, c = h0, c0
    ys = []
    for t in range(xconv.shape[1]):
        rconv = same_conv(h, rec_kernel, (1, 1), cdt, out_dtype=cdt).float()
        z = (xconv[:, t].float() + bias) + rconv
        i = torch.sigmoid(z[..., :f])
        fg = torch.sigmoid(z[..., f : 2 * f])
        c = fg * c + i * torch.tanh(z[..., 2 * f : 3 * f])
        h = torch.sigmoid(z[..., 3 * f :]) * torch.tanh(c)
        ys.append(h.to(cdt))
    return torch.stack(ys, dim=1), (h, c)


def _check(name, t, shape, dtype, device):
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"convlstm_scan: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"convlstm_scan: {name} is {t.dtype}, expected {dtype}")
    if t.device != device:
        raise ValueError(f"convlstm_scan: {name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"convlstm_scan: {name} must be contiguous")


def _launch_kernel(xconv, h0, c0, rec_kernel, bias):
    from .._build import load_library

    if xconv.dtype not in _DTYPE_CODES:
        raise TypeError(f"convlstm_scan: unsupported compute dtype {xconv.dtype}")
    if xconv.dim() != 5 or xconv.shape[-1] % 4:
        raise ValueError(f"convlstm_scan: xconv must be [B, T, H, W, 4f], got {tuple(xconv.shape)}")
    b, t, ho, wo, f4 = xconv.shape
    f = f4 // 4
    kh, kw = rec_kernel.shape[0], rec_kernel.shape[1]
    cdt, dev = xconv.dtype, xconv.device
    if torch.is_grad_enabled() and any(
        x.requires_grad for x in (xconv, h0, c0, rec_kernel, bias)
    ):
        raise NotImplementedError(
            "convlstm_scan: the CUDA kernel is forward-only; run under "
            "torch.no_grad() or torch.inference_mode()"
        )
    _check("xconv", xconv, (b, t, ho, wo, f4), cdt, dev)
    _check("h0", h0, (b, ho, wo, f), torch.float32, dev)
    _check("c0", c0, (b, ho, wo, f), torch.float32, dev)
    _check("rec_kernel", rec_kernel, (kh, kw, f, f4), None, dev)
    _check("bias", bias, (f4,), torch.float32, dev)
    # Rounded to the compute dtype, held as f32, the four gates of each
    # (ci, j) side by side: [kh, kw, f, f, 4], one 16-byte load a weight.
    rk4 = (
        rec_kernel.detach().to(cdt).float()
        .reshape(kh, kw, f, 4, f).transpose(3, 4).contiguous()
    )

    lib = load_library()
    y = torch.empty(b, t, ho, wo, f, dtype=cdt, device=dev)
    # h is read through the conv halo, so it is double-buffered; c is too,
    # so that the caller's (h0, c0) are never written.
    hbuf = [torch.empty_like(h0), torch.empty_like(h0)]
    cbuf = [torch.empty_like(c0), torch.empty_like(c0)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    isz = xconv.element_size()
    x_bstride, y_bstride = t * ho * wo * f4, t * ho * wo * f
    h_prev, c_prev = h0, c0
    for s in range(t):
        h_next, c_next = hbuf[s % 2], cbuf[s % 2]
        err = lib.kccot_convlstm_fwd_step(
            _DTYPE_CODES[cdt],
            xconv.data_ptr() + s * ho * wo * f4 * isz, x_bstride,
            h_prev.data_ptr(), c_prev.data_ptr(),
            rk4.data_ptr(), bias.data_ptr(),
            h_next.data_ptr(), c_next.data_ptr(),
            y.data_ptr() + s * ho * wo * f * isz, y_bstride,
            b, ho, wo, f, kh, kw, stream,
        )
        if err:
            raise RuntimeError(
                f"convlstm_fwd launch failed: {lib.kccot_error_string(err).decode()}"
            )
        convlstm_scan.launches += 1
        h_prev, c_prev = h_next, c_next
    return y, (h_prev, c_prev)


def convlstm_scan(xconv, h0, c0, rec_kernel, bias):
    """The fused ConvLSTM recurrence (contract in the module docstring).

    CPU tensors take the plain version; CUDA tensors launch the Hopper
    kernel, one launch per time step, each counted in
    ``convlstm_scan.launches``.  Anything the kernel does not take raises.
    """
    devices = {x.device.type for x in (xconv, h0, c0, rec_kernel, bias)}
    if devices == {"cpu"}:
        return convlstm_scan_reference(xconv, h0, c0, rec_kernel, bias)
    if devices == {"cuda"}:
        return _launch_kernel(xconv, h0, c0, rec_kernel, bias)
    raise ValueError(f"convlstm_scan: inputs on devices {sorted(devices)}")


convlstm_scan.launches = 0

