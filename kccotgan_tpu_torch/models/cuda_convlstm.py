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
``ConvLstmScan``, whose forward also keeps the f32 c stack and the f32
gate stack ``gates [B, T, H', W', 4f]``, each step's pre-activations
``z_t`` with gate g of channel j at ``4j + g``, and whose backward is the
reverse-time adjoint of ``_bwd_kernel`` (``convlstm_bwd``): the cell
adjoint on the saved gates and the c stack (``_bwd_kernel`` recomputes
the gates; ``convlstm_bwd_reference`` still does), ``dx = cdt(dz)``,
``db`` summed from the f32 ``dz``, ``dh_{t-1}`` the transposed conv of
``cdt(dz)`` kept in f32, and ``drk`` the sum of ``cdt(h_{t-1})^T
cdt(dz)`` over steps, samples and pixels.

Recurrent dropout (``rec_masks [4, B, H', W', f]``, Keras
``recurrent_dropout`` of ``layers.ConvLSTM2D``): gate g's conv reads
``hm_g = cdt(h_{t-1} * rec_masks[g])`` instead of ``cdt(h_{t-1})``.  The
forward then also returns ``hm = (hm0, hm stack)``, gate-major ``[B, H',
W', 4f]`` frames (channel ``g*f + j``) for ``t = -1 .. T-2``, which the
backward reads: ``dh_{t-1} = sum_g mask_g * dhm_g`` and gate g's columns
of ``drk`` sum ``hm_g^T dz_g``.

Dispatch: CPU tensors run the plain versions (``convlstm_fwd_reference``'s
loop, and ``convlstm_bwd_reference``'s on the saved gates); CUDA tensors
launch ``csrc/convlstm_fwd.cu`` once per time step and
``csrc/convlstm_bwd.cu`` twice per step (the cell adjoint, then dh) plus
twice for the weight gradient (or raise).
The compute dtype picks the engine inside each kernel: bf16 runs the
recurrent conv, dh and drk as implicit GEMMs on the tensor cores, with
the weights packed here once per call (``_pack_gates`` in the forward,
``_pack_dh`` in the backward); f32 runs them on the CUDA cores in f32
FMA (``_rk4``).  Under recurrent dropout the same kernels run in their
masked mode, with the launches of the unmasked ones: bf16 takes the
gate GEMM over the four masked h's and the block-diagonal weight
(``_block_diagonal``), dh with gate-quad columns (``_pack_dh_gates``);
f32 reads ``_rk4`` gate by gate.  Each wrapper counts its calls in
``.calls`` and its kernel launches in ``.launches``; ``convlstm_fwd``
counts in ``.gate_stacks`` the calls that wrote a gate stack, on either
device.

Inference (no gradient, no masks) goes through the registered operator
``torch.ops.kccot.convlstm_fwd`` (``convlstm_fwd_op``): ``(xconv, h0,
c0, rec_kernel, bias) -> (y, h_n, c_n)``, whose CPU implementation is
the plain version and whose CUDA implementation launches the forward
kernel once a step.  Its fake implementation gives the shapes from the
inputs' shapes, so ``torch.export`` traces the rollout through it with a
symbolic batch (``export.py``).  Importing this module registers it.
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
    "convlstm_fwd_op",
    "convlstm_fwd_reference",
    "convlstm_scan",
    "convlstm_scan_reference",
]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _same_pads(k: int) -> tuple[int, int]:
    lo = (k - 1) // 2
    return lo, k - 1 - lo


def _rconv(h, rec_kernel, cdt, rec_masks):
    """The recurrent conv of ``h``, rounded to the compute dtype; with
    ``rec_masks [4, B, H, W, f]`` each gate's conv reads its masked ``h``."""
    if rec_masks is None:
        return same_conv(h, rec_kernel, (1, 1), cdt, out_dtype=cdt).float()
    f = h.shape[-1]
    return torch.cat([
        same_conv(h * m, rec_kernel[..., g * f : (g + 1) * f], (1, 1), cdt, out_dtype=cdt).float()
        for g, m in enumerate(rec_masks)
    ], dim=-1)


def _gate_major(rec_masks):
    """The masks ``[4, B, H, W, f]`` as the kernels read them, ``[B, H, W,
    4f]`` float32 with gate g's at channel ``g*f + j``."""
    g, b, h, w, f = rec_masks.shape
    return rec_masks.permute(1, 2, 3, 0, 4).reshape(b, h, w, g * f).float().contiguous()


def _masked_h(h, mask, cdt):
    """``hm = cdt(h * mask_g)`` of every gate, gate-major ``[B, H, W, 4f]``."""
    b, hh, ww, f = h.shape
    return (h.unsqueeze(3) * mask.view(b, hh, ww, 4, f)).reshape(b, hh, ww, 4 * f).to(cdt)


def _gate_quads(z):
    """Gate-major ``[..., 4f]`` (channel ``g*f + j``) -> the gate stack's
    ``[..., 4f]`` (``4j + g``)."""
    return z.unflatten(-1, (4, -1)).transpose(-1, -2).flatten(-2)


def _gate_major_z(gq):
    """The gate stack's ``[..., 4f]`` (``4j + g``) -> gate-major."""
    return gq.unflatten(-1, (-1, 4)).transpose(-1, -2).flatten(-2)


def _fwd_plain(xconv, h0, c0, rec_kernel, bias, rec_masks, with_gates=False):
    """``(y, c_stack, h_n, c_n, hm, gates)``; ``hm`` is ``(hm0, hm stack)``
    under ``rec_masks`` (the module docstring), else None; ``gates`` the
    gate stack if ``with_gates``, else None."""
    cdt = xconv.dtype
    f = h0.shape[-1]
    h, c = h0, c0
    ys, cs, hms, zs = [], [], [], []
    mask = _gate_major(rec_masks) if rec_masks is not None else None
    for t in range(xconv.shape[1]):
        if mask is not None:
            hms.append(_masked_h(h, mask, cdt))
        rconv = _rconv(h, rec_kernel, cdt, rec_masks)
        z = (xconv[:, t].float() + bias) + rconv
        if with_gates:
            zs.append(_gate_quads(z))
        i = torch.sigmoid(z[..., :f])
        fg = torch.sigmoid(z[..., f : 2 * f])
        c = fg * c + i * torch.tanh(z[..., 2 * f : 3 * f])
        h = torch.sigmoid(z[..., 3 * f :]) * torch.tanh(c)
        ys.append(h.to(cdt))
        cs.append(c)
    hm = None
    if mask is not None:  # the stack's slot t holds hm_t; its last slot is never read
        hm = (hms[0], torch.stack(hms[1:] + hms[-1:], dim=1))
    gates = torch.stack(zs, dim=1) if with_gates else None
    return torch.stack(ys, dim=1), torch.stack(cs, dim=1), h, c, hm, gates


def convlstm_fwd_reference(xconv, h0, c0, rec_kernel, bias, rec_masks=None):
    """Plain PyTorch recurrence: ``(y, c_stack, h_n, c_n)``, the kernel's
    oracle and the CPU path.  ``rec_masks`` applies Keras recurrent
    dropout (``layers.ConvLSTM2D``) one gate's conv at a time."""
    return _fwd_plain(xconv, h0, c0, rec_kernel, bias, rec_masks)[:4]


def convlstm_scan_reference(xconv, h0, c0, rec_kernel, bias, rec_masks=None):
    """``(y, (h_n, c_n))`` of the plain recurrence; autograd differentiates
    it (the training step's recurrence under ``kernel_impl='scan'``)."""
    y, _, h, c = convlstm_fwd_reference(xconv, h0, c0, rec_kernel, bias, rec_masks)
    return y, (h, c)


def _shifted(hp, kh, kw):
    """The kh*kw shifted [B, H, W, f] windows of ``hp`` under 'SAME' pads."""
    (lh, hh), (lw, hw) = _same_pads(kh), _same_pads(kw)
    ho, wo = hp.shape[1], hp.shape[2]
    padded = F.pad(hp, (0, 0, lw, hw, lh, hh))
    return [[padded[:, ky : ky + ho, kx : kx + wo] for kx in range(kw)] for ky in range(kh)]


def convlstm_bwd_reference(xconv, h0, c0, rec_kernel, bias, y, c_stack, dy, dh_n, dc_n,
                           rec_masks=None, hm=None):
    """Plain port of ``_bwd_kernel``: ``(dx, dh0, dc0, drk, db)``, the
    gates recomputed at each reverse step as the TPU kernel does.

    ``dy`` is in the compute dtype; the products of compute-dtype values
    are summed in f32 (the kernel's ``preferred_element_type``), and only
    the recomputed recurrent conv is rounded to the compute dtype.  With
    ``rec_masks`` and the forward's ``hm``, the recurrence of the masked
    h's, as one conv over the gate-major ``hm`` with the block-diagonal
    weight."""
    cdt = xconv.dtype
    rk = _block_diagonal(rec_kernel) if rec_masks is not None else rec_kernel

    def gates_at(t, hp):
        rconv = same_conv(hp, rk, (1, 1), cdt, out_dtype=cdt).float()
        return (xconv[:, t].float() + bias) + rconv

    return _bwd_plain(gates_at, xconv.shape, h0, c0, rec_kernel, y, c_stack, dy, dh_n, dc_n,
                      rec_masks, hm)


def _bwd_plain(gates_at, shape, h0, c0, rec_kernel, y, c_stack, dy, dh_n, dc_n, rec_masks, hm):
    """The reverse loop of ``convlstm_bwd_reference``: ``gates_at(t,
    hp)`` gives step t's gate-major pre-activations ``z_t`` from ``hp``,
    the compute-dtype h (or masked h's) its recurrent conv read."""
    cdt = y.dtype
    b, t_total, ho, wo, f4 = shape
    f = f4 // 4
    kh, kw = rec_kernel.shape[0], rec_kernel.shape[1]
    masked = rec_masks is not None
    if masked:
        mask = _gate_major(rec_masks).view(b, ho, wo, 4, f)
        rec_kernel = _block_diagonal(rec_kernel)
    rk = rec_kernel.to(cdt).float()
    cin = rk.shape[2]
    dh, dc = dh_n.float(), dc_n.float()
    dx = torch.empty(shape, dtype=cdt, device=y.device)
    drk = torch.zeros(kh, kw, cin, f4, dtype=torch.float32, device=y.device)
    db = torch.zeros(f4, dtype=torch.float32, device=y.device)
    # dh_prev: correlate dz with the flipped kernel, pads (hi, lo) swapped
    w_t = torch.flip(rk, (0, 1)).permute(2, 3, 0, 1)  # [f, 4f, kh, kw]
    (lh, hh), (lw, hw) = _same_pads(kh), _same_pads(kw)
    for t in reversed(range(t_total)):
        c_prev = c0 if t == 0 else c_stack[:, t - 1]
        if masked:
            hp = hm[0] if t == 0 else hm[1][:, t - 1]
        else:
            hp = (h0 if t == 0 else y[:, t - 1]).to(cdt)
        z = gates_at(t, hp)
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
        if masked:
            dh = (dh.reshape(b, ho, wo, 4, f) * mask).sum(3)
        hpf = hp.float()
        for ky, row in enumerate(_shifted(hpf, kh, kw)):
            for kx, sl in enumerate(row):
                drk[ky, kx] += sl.reshape(-1, cin).T @ dzc.reshape(-1, f4)
        dc = dc * fg
    if masked:  # gate g's columns from hm_g's rows: the diagonal blocks
        drk = torch.cat([drk[:, :, g * f : (g + 1) * f, g * f : (g + 1) * f] for g in range(4)], -1)
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


def _quad_columns(w):
    """``[K, 4, f]`` (row, gate, channel) -> ``[K, 16*ceil(f/4)]`` with gate
    g of channel j in column 16*(j//4) + 8*(g//2) + 2*(j%4) + g%2, so
    that one thread's accumulators hold the four gates of a (pixel, j);
    zero columns for the channels past f."""
    k, _, f = w.shape
    jp = -(-f // 4) * 4
    w = F.pad(w, (0, jp - f))  # [K, g, j]
    w = w.reshape(k, 2, 2, jp // 4, 4).permute(0, 3, 1, 4, 2)  # [K, j//4, g//2, j%4, g%2]
    return w.reshape(k, 4 * jp).contiguous()


def _pack_gates(rec_kernel, cdt):
    """cdt(rk) ``[kh, kw, cin, 4f]`` as the tensor-core gate GEMM's B,
    ``[kh*kw*cin, 16*ceil(f/4)]``: row (ky*kw + kx)*cin + ci, columns by
    ``_quad_columns``.  cin is f, or 4f for the block-diagonal weight."""
    kh, kw, cin, f4 = rec_kernel.shape
    return _quad_columns(rec_kernel.detach().to(cdt).reshape(kh * kw * cin, 4, f4 // 4))


def _block_diagonal(rec_kernel):
    """``[kh, kw, f, 4f]`` -> ``[kh, kw, 4f, 4f]``: input channel g*f + ci
    (``hm_g``'s channel ci) feeds gate g's columns alone, so one conv over
    the gate-major ``hm`` is the four gates' masked convs."""
    kh, kw, f, f4 = rec_kernel.shape
    out = rec_kernel.new_zeros(kh, kw, 4, f, 4, f)
    for g in range(4):
        out[:, :, g, :, g, :] = rec_kernel[..., g * f : (g + 1) * f]
    return out.reshape(kh, kw, f4, f4)


def _pack_dh_gates(rec_kernel, cdt):
    """Under recurrent dropout, cdt(rk) as the tensor-core dh GEMM's B,
    ``[kh*kw*4f, 16*ceil(f/4)]``: row (ky*kw + kx)*4f + n, column (g, ci)
    in ``_quad_columns`` order holding rk[ky, kx, ci, n] where n is a
    channel of gate g, else zero."""
    kh, kw, f, f4 = rec_kernel.shape
    return _quad_columns(
        _block_diagonal(rec_kernel.detach().to(cdt)).permute(0, 1, 3, 2).reshape(kh * kw * f4, 4, f)
    )


def _pack_dh(rec_kernel, cdt):
    """cdt(rk) transposed as the tensor-core dh GEMM's B,
    [kh*kw*4f, 8*ceil(f/8)]: row (ky*kw + kx)*4f + n, column ci."""
    kh, kw, f, f4 = rec_kernel.shape
    w = rec_kernel.detach().to(cdt).permute(0, 1, 3, 2).reshape(kh * kw * f4, f)
    return F.pad(w, (0, -(-f // 8) * 8 - f)).contiguous()


def _masks_for_kernels(rec_masks, b, ho, wo, f, dev):
    """The masks gate-major, checked, or None."""
    if rec_masks is None:
        return None
    _check("rec_masks", rec_masks, (4, b, ho, wo, f), torch.float32, dev)
    return _gate_major(rec_masks)


def _launch_fwd(xconv, h0, c0, rec_kernel, bias, with_c_stack, rec_masks):
    from .._build import load_library

    b, t, ho, wo, f, kh, kw = _geometry(xconv, h0, c0, rec_kernel, bias)
    cdt, dev = xconv.dtype, xconv.device
    mask = _masks_for_kernels(rec_masks, b, ho, wo, f, dev)
    tc = cdt == torch.bfloat16  # tensor cores; they read h_{t-1} as y[t-1] or cdt(h0)
    if tc:
        w = _pack_gates(rec_kernel if mask is None else _block_diagonal(rec_kernel), cdt)
    else:
        w = _rk4(rec_kernel, cdt)
    h0c = h0.to(cdt) if tc and mask is None else None
    if mask is not None:  # every gate's conv reads hm_{t-1}, for both dtypes
        hm0 = _masked_h(h0, mask, cdt)
        hm = torch.empty(b, t, ho, wo, 4 * f, dtype=cdt, device=dev)
    lib = load_library()
    y = torch.empty(b, t, ho, wo, f, dtype=cdt, device=dev)
    cs = gates = None
    if with_c_stack:
        cs = torch.empty(b, t, ho, wo, f, dtype=torch.float32, device=dev)
        gates = torch.empty(b, t, ho, wo, 4 * f, dtype=torch.float32, device=dev)
    # h is read through the conv halo, so it is double-buffered; c is too,
    # so that the caller's (h0, c0) are never written.
    hbuf = [torch.empty_like(h0), torch.empty_like(h0)]
    cbuf = [torch.empty_like(c0), torch.empty_like(c0)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    isz, hw = xconv.element_size(), ho * wo
    x_bstride, y_bstride = t * hw * 4 * f, t * hw * f
    h_prev, c_prev = h0, c0
    convlstm_fwd.calls += 1
    convlstm_fwd.gate_stacks += int(with_c_stack)
    for s in range(t):
        h_next, c_next = hbuf[s % 2], cbuf[s % 2]
        hm_out = None
        if mask is not None:
            if s:
                hp, hp_bstride = hm.data_ptr() + (s - 1) * hw * 4 * f * isz, 4 * y_bstride
            else:
                hp, hp_bstride = hm0.data_ptr(), hw * 4 * f
            if s < t - 1:  # hm_{T-1} is read by no step
                hm_out = hm.data_ptr() + s * hw * 4 * f * isz
        elif not tc:
            hp, hp_bstride = None, 0
        elif s:
            hp, hp_bstride = y.data_ptr() + (s - 1) * hw * f * isz, y_bstride
        else:
            hp, hp_bstride = h0c.data_ptr(), hw * f
        err = lib.kccot_convlstm_fwd_step(
            _DTYPE_CODES[cdt],
            xconv.data_ptr() + s * hw * 4 * f * isz, x_bstride,
            h_prev.data_ptr(), hp, hp_bstride, c_prev.data_ptr(),
            w.data_ptr(), bias.data_ptr(),
            h_next.data_ptr(), c_next.data_ptr(),
            y.data_ptr() + s * hw * f * isz, y_bstride,
            cs.data_ptr() + s * hw * f * 4 if cs is not None else None, y_bstride,
            gates.data_ptr() + s * hw * 4 * f * 4 if gates is not None else None, x_bstride,
            mask.data_ptr() if mask is not None else None, hm_out, 4 * y_bstride,
            b, ho, wo, f, kh, kw, stream,
        )
        _raise_on(lib, err, "convlstm_fwd")
        convlstm_fwd.launches += 1
        h_prev, c_prev = h_next, c_next
    return y, cs, h_prev, c_prev, gates, (hm0, hm) if mask is not None else None


def convlstm_fwd(xconv, h0, c0, rec_kernel, bias, with_c_stack=False, rec_masks=None):
    """``(y, c_stack, h_n, c_n, gates)``: the plain version for CPU tensors,
    the forward kernel (one launch a step) for CUDA tensors.  With
    ``with_c_stack`` (what ``convlstm_bwd`` reads) the f32 c stack and the
    f32 gate stack ``[B, T, H', W', 4f]`` (module docstring), else both
    None.  With ``rec_masks`` (recurrent dropout) a sixth element, ``hm``,
    which ``convlstm_bwd`` takes too."""
    args = (xconv, h0, c0, rec_kernel, bias)
    devices = {x.device.type for x in args if x is not None}
    devices |= {rec_masks.device.type} if rec_masks is not None else set()
    if devices == {"cpu"}:
        y, cs, h, c, hm, gates = _fwd_plain(*args, rec_masks, with_gates=with_c_stack)
        convlstm_fwd.gate_stacks += int(with_c_stack)
        out = y, cs if with_c_stack else None, h, c, gates
    elif devices == {"cuda"}:
        *out, hm = _launch_fwd(*args, with_c_stack, rec_masks)
    else:
        raise ValueError(f"convlstm: inputs on devices {sorted(devices)}")
    return (*out, hm) if rec_masks is not None else tuple(out)


def _wgrad_splits(pixels, tiles):
    """``(splits, chunk)`` of the weight gradient's sum over ``pixels``
    with ``tiles`` output tiles: split until about 4 blocks per SM of 132
    are in flight, but keep at least 256 pixels a split."""
    splits = max(1, min(-(-528 // tiles), pixels // 256))
    return splits, -(-pixels // splits)


def recurrent_wgrad(lib, y, h0c, dx, dbpart, kh, kw, masked=False):
    """``(drk [kh, kw, f, 4f], db [4f])`` by ``kccot_recurrent_wgrad``
    (two launches): ``y [B, T, H, W, f]`` and ``h0c`` give ``cdt(h_{t-1})``,
    ``dx [B, T, H, W, 4f]`` is ``cdt(dz)``, ``dbpart [rows, 4f]`` the f32
    partial sums of dz.  ``masked``: y and h0c are the hm stack and hm0,
    ``[B, *, H, W, 4f]`` (recurrent dropout)."""
    b, t, ho, wo, f = dx.shape
    f //= 4
    f4, m = 4 * f, kh * kw * f
    pixels = b * t * ho * wo
    code = _DTYPE_CODES[y.dtype]
    splits, chunk = _wgrad_splits(pixels, lib.kccot_recurrent_wgrad_tiles(code, m, f, int(masked)))
    dev = y.device
    part = torch.empty(splits, m, f4, dtype=torch.float32, device=dev)
    drk = torch.empty(kh, kw, f, f4, dtype=torch.float32, device=dev)
    db = torch.empty(f4, dtype=torch.float32, device=dev)
    err = lib.kccot_recurrent_wgrad(
        code, y.data_ptr(), h0c.data_ptr(), dx.data_ptr(), part.data_ptr(),
        splits, chunk, dbpart.data_ptr(), dbpart.shape[0], drk.data_ptr(), db.data_ptr(),
        b, t, ho, wo, f, kh, kw, int(masked), torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(lib, err, "recurrent_wgrad")
    return drk, db


def _bwd_geometry(gates, h0, c0, rec_kernel, y, c_stack, dy, dh_n, dc_n):
    """Checks the backward's inputs; returns ``(b, t, ho, wo, f, kh, kw)``."""
    cdt = y.dtype
    if cdt not in _DTYPE_CODES:
        raise TypeError(f"convlstm: unsupported compute dtype {cdt}")
    if y.dim() != 5:
        raise ValueError(f"convlstm: y must be [B, T, H, W, f], got {tuple(y.shape)}")
    b, t, ho, wo, f = y.shape
    kh, kw = rec_kernel.shape[0], rec_kernel.shape[1]
    dev = y.device
    _check("gates", gates, (b, t, ho, wo, 4 * f), torch.float32, dev)
    for name, x, dtype in (("y", y, cdt), ("c_stack", c_stack, torch.float32), ("dy", dy, cdt)):
        _check(name, x, (b, t, ho, wo, f), dtype, dev)
    for name, x in (("h0", h0), ("c0", c0), ("dh_n", dh_n), ("dc_n", dc_n)):
        _check(name, x, (b, ho, wo, f), torch.float32, dev)
    _check("rec_kernel", rec_kernel, (kh, kw, f, 4 * f), None, dev)
    return b, t, ho, wo, f, kh, kw


def _launch_bwd(gates, h0, c0, rec_kernel, y, c_stack, dy, dh_n, dc_n, rec_masks, hm):
    from .._build import load_library

    b, t, ho, wo, f, kh, kw = _bwd_geometry(gates, h0, c0, rec_kernel, y, c_stack, dy, dh_n, dc_n)
    cdt, dev = y.dtype, y.device
    f4 = 4 * f
    mask = _masks_for_kernels(rec_masks, b, ho, wo, f, dev)
    if mask is not None:
        if hm is None:
            raise ValueError("convlstm: recurrent dropout's backward needs the forward's hm")
        _check("hm0", hm[0], (b, ho, wo, f4), cdt, dev)
        _check("hm", hm[1], (b, t, ho, wo, f4), cdt, dev)
    if cdt == torch.bfloat16:  # tensor cores
        wT = _pack_dh(rec_kernel, cdt) if mask is None else _pack_dh_gates(rec_kernel, cdt)
    else:
        # [kh, kw, 4f/4, f, 4]: four consecutive output channels n of one ci
        wT = (
            rec_kernel.detach().to(cdt).float()
            .reshape(kh, kw, f, f4 // 4, 4).permute(0, 1, 3, 2, 4).contiguous()
        )
    lib = load_library()
    code = _DTYPE_CODES[cdt]
    dh, dc = dh_n.clone(), dc_n.clone()
    dx = torch.empty(b, t, ho, wo, f4, dtype=cdt, device=dev)
    dbpart = torch.zeros(lib.kccot_convlstm_bwd_rows(b, ho, wo, f), f4, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    isz, hw = dx.element_size(), ho * wo
    x_bs, y_bs = t * hw * f4, t * hw * f
    convlstm_bwd.calls += 1
    for s in reversed(range(t)):
        if s:
            cp, cp_bs = c_stack.data_ptr() + (s - 1) * hw * f * 4, y_bs
        else:
            cp, cp_bs = c0.data_ptr(), hw * f
        dx_t = dx.data_ptr() + s * hw * f4 * isz
        err = lib.kccot_convlstm_bwd_step(
            code, gates.data_ptr() + s * hw * f4 * 4, x_bs, cp, cp_bs,
            dy.data_ptr() + s * hw * f * isz, y_bs, dh.data_ptr(), dc.data_ptr(), dx_t, x_bs,
            dbpart.data_ptr(), b, ho, wo, f, stream,
        )
        _raise_on(lib, err, "convlstm_bwd step")
        err = lib.kccot_convlstm_bwd_dh(
            code, dx_t, x_bs, wT.data_ptr(), mask.data_ptr() if mask is not None else None,
            dh.data_ptr(), b, ho, wo, f, kh, kw, stream,
        )
        _raise_on(lib, err, "convlstm_bwd dh")
        convlstm_bwd.launches += 2
    # hm_{t-1} (masked) or cdt(h_{t-1}): the stack at t-1, or its t = 0 frame,
    # h_{-1} rounded to the compute dtype as the kernels read y
    h_stack, h_first = (hm[1], hm[0]) if mask is not None else (y, h0.to(cdt))
    drk, db = recurrent_wgrad(lib, h_stack, h_first, dx, dbpart, kh, kw, mask is not None)
    convlstm_bwd.launches += 2
    return dx, dh, dc, drk, db


def convlstm_bwd(gates, h0, c0, rec_kernel, y, c_stack, dy, dh_n, dc_n, rec_masks=None, hm=None):
    """``(dx, dh0, dc0, drk, db)`` of the recurrence from what the forward
    kept under ``with_c_stack``: the gate stack, y and the c stack (and
    under recurrent dropout ``rec_masks`` and ``hm``).  The cell adjoint
    runs on the saved gates, recomputing nothing: in plain PyTorch for
    CPU tensors, by the backward kernels for CUDA tensors."""
    args = (gates, h0, c0, rec_kernel, y, c_stack, dy, dh_n, dc_n)
    devices = {x.device.type for x in args}
    devices |= {rec_masks.device.type} if rec_masks is not None else set()
    if devices == {"cpu"}:
        return _bwd_plain(lambda t, hp: _gate_major_z(gates[:, t]), gates.shape, h0, c0, rec_kernel,
                          y, c_stack, dy, dh_n, dc_n, rec_masks, hm)
    if devices == {"cuda"}:
        return _launch_bwd(*args, rec_masks, hm)
    raise ValueError(f"convlstm: inputs on devices {sorted(devices)}")


for _fn in (convlstm_fwd, convlstm_bwd):
    _fn.calls = _fn.launches = 0
convlstm_fwd.gate_stacks = 0


@torch.library.custom_op(
    "kccot::convlstm_fwd", mutates_args=(), device_types="cpu",
    schema="(Tensor xconv, Tensor h0, Tensor c0, Tensor rec_kernel, Tensor bias) -> (Tensor, Tensor, Tensor)",
)
def convlstm_fwd_op(xconv, h0, c0, rec_kernel, bias):
    """The recurrence's forward without the c stack, ``(y, h_n, c_n)``: on
    the CPU the plain version."""
    y, _, h, c, _, _ = _fwd_plain(xconv, h0, c0, rec_kernel, bias, None)
    return y, h, c


@convlstm_fwd_op.register_kernel("cuda")
def _convlstm_fwd_cuda(xconv, h0, c0, rec_kernel, bias):
    # An exported program reaches here with the strides its conv gave at
    # run time, which tracing may not have foreseen; the kernel takes
    # C-contiguous tensors.
    args = [x.contiguous() for x in (xconv, h0, c0, rec_kernel, bias)]
    y, _, h, c, _, _ = _launch_fwd(*args, False, None)
    return y, h, c


@convlstm_fwd_op.register_fake
def _convlstm_fwd_fake(xconv, h0, c0, rec_kernel, bias):
    b, t, ho, wo, f4 = xconv.shape
    return xconv.new_empty(b, t, ho, wo, f4 // 4), h0.new_empty(h0.shape), c0.new_empty(c0.shape)


class ConvLstmScan(torch.autograd.Function):
    """The recurrence under autograd: saves ``(gates, h0, c0, rec_kernel,
    y, c_stack)``, the forward's f32 gate stack in place of the
    ``xconv`` and ``bias`` that ``_vjp_fwd`` saves to recompute the gates,
    and under recurrent dropout the masks and ``hm``; unused ``(h_n,
    c_n)`` count as zero cotangents.  The masks are constants (no
    gradient)."""

    @staticmethod
    def forward(ctx, xconv, h0, c0, rec_kernel, bias, rec_masks=None):
        y, cs, h, c, gates, *hm = convlstm_fwd(
            xconv, h0, c0, rec_kernel, bias, with_c_stack=True, rec_masks=rec_masks
        )
        hm = hm[0] if hm else (None, None)
        ctx.save_for_backward(gates, h0, c0, rec_kernel, y, cs, rec_masks, *hm)
        ctx.bias_dtype = bias.dtype
        return y, h, c

    @staticmethod
    def backward(ctx, dy, dh_n, dc_n):
        gates, h0, c0, rec_kernel, y, cs, rec_masks, hm0, hm = ctx.saved_tensors
        dx, dh0, dc0, drk, db = convlstm_bwd(
            gates, h0, c0, rec_kernel, y, cs,
            dy.to(y.dtype).contiguous(), dh_n.float().contiguous(), dc_n.float().contiguous(),
            rec_masks, (hm0, hm) if rec_masks is not None else None,
        )
        return dx, dh0, dc0, drk.to(rec_kernel.dtype), db.to(ctx.bias_dtype), None


def convlstm_scan(xconv, h0, c0, rec_kernel, bias, rec_masks=None):
    """The fused ConvLSTM recurrence (contract in the module docstring):
    ``ConvLstmScan`` when autograd needs a gradient, else the forward
    alone (without masks, the registered operator ``convlstm_fwd_op``).
    CPU tensors take the plain versions, CUDA tensors the kernels;
    anything the kernels do not take raises.  ``rec_masks [4, B, H', W',
    f]``: Keras recurrent dropout, one mask a gate."""
    args = (xconv, h0, c0, rec_kernel, bias)
    if torch.is_grad_enabled() and any(x.requires_grad for x in args):
        y, h, c = ConvLstmScan.apply(*args, rec_masks)
        return y, (h, c)
    if rec_masks is None:
        devices = {x.device.type for x in args}
        if devices not in ({"cpu"}, {"cuda"}):  # the dispatcher would pick one
            raise ValueError(f"convlstm: inputs on devices {sorted(devices)}")
        if devices == {"cuda"} and not torch.compiler.is_exporting():
            # a live call takes what the kernel takes; the operator makes
            # only an exported program's run-time strides contiguous
            for name, x in zip(("xconv", "h0", "c0", "rec_kernel", "bias"), args):
                if not x.is_contiguous():
                    raise ValueError(f"convlstm: {name} must be contiguous")
        y, h, c = convlstm_fwd_op(*args)
        return y, (h, c)
    y, _, h, c, *_ = convlstm_fwd(*args, rec_masks=rec_masks)
    return y, (h, c)
