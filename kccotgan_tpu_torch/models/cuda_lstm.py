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
launch for all T steps) and, backward, ``csrc/lstm_bwd.cu`` (all T
steps, dR and db in one launch; two where the batch needs more blocks
than one thread-block cluster holds, ``kccot_lstm_bwd_scratch``), or
raise.  The kernels stage R in shared memory up to U = 64, and in bf16
up to 128 (tensor cores); past that, up to ``kccot_lstm_max_units()``
(5,282), kernels on the CUDA cores read it through L2 at every step.
Past U = 64 the backward sums dR and db in a second launch.  The
kernels take the f32 recurrent kernel as stored, rounding it
themselves: a call launches nothing but its kernels.  Each wrapper
counts its calls in ``.calls`` and its kernel launches in
``.launches``.

Instance axis: every function here also takes N independent problems
stacked on a leading axis (``xproj [N, B, T, 4U]``, ``h0``, ``c0 [N, B,
U]``, ``rec_kernel [N, U, 4U]``, ``bias [N, 4U]``; outputs, ``dR`` and
``db`` likewise), the counterpart of ``pallas_call``'s batching rule
under ``jax.vmap``.  The kernels run all N in the launches of one
problem, each instance equal to its own call to the bit; the plain
versions loop over the instances.  ``LstmScan``'s ``vmap`` rule stacks
a ``torch.func.vmap`` dimension into that axis, so the fused
discriminators (``train/steps.py``) launch each kernel once for their
four passes.
"""

from __future__ import annotations

import functools

import torch

from .cuda_convlstm import _DTYPE_CODES, _raise_on
from .cuda_convlstm import _check as _check_tensor

__all__ = ["LstmScan", "lstm_bwd", "lstm_bwd_reference", "lstm_fwd", "lstm_scan", "lstm_scan_reference"]

_ACT = {"tanh": torch.tanh, "sigmoid": torch.sigmoid}
_ACT_CODES = {"tanh": 0, "sigmoid": 1}


def _dact(name, a):
    """The activation's derivative written on its value ``a``."""
    return 1.0 - a * a if name == "tanh" else a * (1.0 - a)


def _per_instance(fn, *args):
    """``fn`` over the leading instance axis of ``args`` (None passes
    through), its outputs stacked."""
    outs = [fn(*(None if a is None else a[i] for a in args)) for i in range(args[0].shape[0])]
    return tuple(torch.stack(o) for o in zip(*outs))


def lstm_scan_reference(xproj, h0, c0, rec_kernel, bias, activation="tanh"):
    """Plain PyTorch recurrence: ``(y, c_stack, h_n, c_n)``, the kernel's
    oracle and the CPU path; autograd differentiates it under
    ``kernel_impl='scan'``."""
    if xproj.dim() == 4:
        return _per_instance(functools.partial(lstm_scan_reference, activation=activation),
                             xproj, h0, c0, rec_kernel, bias)
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
    if xproj.dim() == 4:
        return _per_instance(functools.partial(lstm_bwd_reference, activation=activation),
                             xproj, h0, c0, rec_kernel, bias, y, c_stack, dy, dh_n, dc_n)
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
    if xproj.dim() not in (3, 4) or xproj.shape[-1] % 4:
        raise ValueError(f"lstm: xproj must be [B, T, 4U] or [N, B, T, 4U], got {tuple(xproj.shape)}")
    lead = tuple(xproj.shape[:-3])  # (N,) with an instance axis
    b, t, u4 = xproj.shape[-3:]
    u, dev = u4 // 4, xproj.device
    _check("xproj", xproj, (*lead, b, t, u4), xproj.dtype, dev)
    _check("h0", h0, (*lead, b, u), torch.float32, dev)
    _check("c0", c0, (*lead, b, u), torch.float32, dev)
    _check("rec_kernel", rec_kernel, (*lead, u, u4), torch.float32, dev)
    _check("bias", bias, (*lead, u4), torch.float32, dev)
    return lead, b, t, u


def _ptr(x):
    return x.data_ptr() if x is not None else None


def _instances(lead):
    return lead[0] if lead else 1


def _library(u):
    from .._build import load_library

    lib = load_library()
    if u > lib.kccot_lstm_max_units():
        raise ValueError(f"lstm: the kernels take at most {lib.kccot_lstm_max_units()} units, got {u}")
    return lib


def _launch_fwd(xproj, h0, c0, rec_kernel, bias, activation, with_c_stack):
    lead, b, t, u = _geometry(xproj, h0, c0, rec_kernel, bias, activation)
    cdt, dev = xproj.dtype, xproj.device
    lib = _library(u)
    y = torch.empty(*lead, b, t, u, dtype=cdt, device=dev)
    cs = torch.empty(*lead, b, t, u, dtype=torch.float32, device=dev) if with_c_stack else None
    hn, cn = torch.empty_like(h0), torch.empty_like(c0)
    lstm_fwd.calls += 1
    err = lib.kccot_lstm_fwd(
        _DTYPE_CODES[cdt], _ACT_CODES[activation], xproj.data_ptr(), h0.data_ptr(),
        c0.data_ptr(), rec_kernel.data_ptr(), bias.data_ptr(), y.data_ptr(), _ptr(cs),
        hn.data_ptr(), cn.data_ptr(), _instances(lead), b, t, u,
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
    lead, b, t, u = _geometry(xproj, h0, c0, rec_kernel, bias, activation)
    cdt, dev = xproj.dtype, xproj.device
    _check("y", y, (*lead, b, t, u), cdt, dev)
    _check("c_stack", c_stack, (*lead, b, t, u), torch.float32, dev)
    for name, x, shape, dtype in (("dy", dy, (*lead, b, t, u), cdt),
                                  ("dh_n", dh_n, (*lead, b, u), torch.float32),
                                  ("dc_n", dc_n, (*lead, b, u), torch.float32)):
        if x is not None:  # None: a zero cotangent
            _check(name, x, shape, dtype, dev)
    lib = _library(u)
    code = _DTYPE_CODES[cdt]
    # more blocks than one cluster, or U > 64: their dR and db partials
    # (db alone past U = 64) go through this scratch and a second,
    # fixed-order launch
    n = _instances(lead)
    scratch = lib.kccot_lstm_bwd_scratch(code, n, b, u)
    part = torch.empty(scratch, dtype=torch.float32, device=dev) if scratch else None
    dx = torch.empty_like(xproj)
    dh0, dc0 = torch.empty_like(h0), torch.empty_like(c0)
    drk = torch.empty(*lead, u, 4 * u, dtype=torch.float32, device=dev)
    db = torch.empty(*lead, 4 * u, dtype=torch.float32, device=dev)
    lstm_bwd.calls += 1
    err = lib.kccot_lstm_bwd(
        code, _ACT_CODES[activation], xproj.data_ptr(), y.data_ptr(), c_stack.data_ptr(),
        h0.data_ptr(), c0.data_ptr(), rec_kernel.data_ptr(), bias.data_ptr(), _ptr(dy), _ptr(dh_n), _ptr(dc_n), dx.data_ptr(), dh0.data_ptr(),
        dc0.data_ptr(), drk.data_ptr(), db.data_ptr(), _ptr(part), n, b, t, u,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(lib, err, "lstm_bwd")
    lstm_bwd.launches += 1 if part is None else 2
    return dx, dh0, dc0, drk, db


def lstm_bwd(xproj, h0, c0, rec_kernel, bias, y, c_stack, dy, dh_n, dc_n, activation="tanh"):
    """``(dx, dh0, dc0, dR, db)``: the plain version for CPU tensors, the
    backward kernel for CUDA tensors.  ``dy``, ``dh_n`` and ``dc_n`` may
    be None (zero cotangents)."""
    args = (xproj, h0, c0, rec_kernel, bias, y, c_stack, dy, dh_n, dc_n)
    devices = {x.device.type for x in args if x is not None}
    if devices == {"cpu"}:
        dy = torch.zeros_like(y) if dy is None else dy
        dh_n, dc_n = (torch.zeros_like(h0) if x is None else x for x in (dh_n, dc_n))
        return lstm_bwd_reference(*args[:7], dy, dh_n, dc_n, activation)
    if devices == {"cuda"}:
        return _launch_bwd(*args, activation)
    raise ValueError(f"lstm: inputs on devices {sorted(devices)}")


for _fn in (lstm_fwd, lstm_bwd):
    _fn.calls = _fn.launches = 0


class LstmScan(torch.autograd.Function):
    """The recurrence under autograd: ``apply`` returns ``(y, h_n, c_n)``
    and saves ``(xproj, h0, c0, rec_kernel, bias, y, c_stack)`` as
    ``_vjp_fwd`` does; unused ``(h_n, c_n)`` count as zero cotangents.
    Under ``torch.func.vmap`` the ``vmap`` rule moves the vmapped
    dimension to the front, as the instance axis, and applies the
    Function once to all instances."""

    @classmethod
    def apply(cls, xproj, h0, c0, rec_kernel, bias, activation):
        """``(y, h_n, c_n)``: the c stack is an output only for
        ``setup_context`` to save."""
        return super().apply(xproj, h0, c0, rec_kernel, bias, activation)[:3]

    @staticmethod
    def forward(xproj, h0, c0, rec_kernel, bias, activation):
        y, cs, h, c = lstm_fwd(xproj, h0, c0, rec_kernel, bias, activation, with_c_stack=True)
        return y, h, c, cs

    @staticmethod
    def setup_context(ctx, inputs, output):
        *tensors, activation = inputs
        y, _, _, cs = output
        ctx.activation = activation
        ctx.save_for_backward(*tensors, y, cs)
        ctx.mark_non_differentiable(cs)
        # unused outputs' cotangents arrive as None, not as zero tensors
        # filled on the device: the kernel reads None as zero
        ctx.set_materialize_grads(False)

    @staticmethod
    def vmap(info, in_dims, xproj, h0, c0, rec_kernel, bias, activation):
        args = [x.movedim(d, 0) if d is not None else x.expand(info.batch_size, *x.shape)
                for x, d in zip((xproj, h0, c0, rec_kernel, bias), in_dims[:5])]
        if args[0].dim() != 4:
            raise ValueError("lstm: one instance axis at most (nested vmap)")
        outs = super(LstmScan, LstmScan).apply(*(x.contiguous() for x in args), activation)
        return outs, (0, 0, 0, 0)

    @staticmethod
    def backward(ctx, dy, dh_n, dc_n, _):
        xproj, h0, c0, rec_kernel, bias, y, cs = ctx.saved_tensors
        dx, dh0, dc0, drk, db = lstm_bwd(
            xproj, h0, c0, rec_kernel, bias, y, cs,
            None if dy is None else dy.to(xproj.dtype).contiguous(),
            None if dh_n is None else dh_n.float().contiguous(),
            None if dc_n is None else dc_n.float().contiguous(), ctx.activation,
        )
        return dx, dh0, dc0, drk.to(rec_kernel.dtype), db.to(bias.dtype), None


def lstm_scan(xproj, h0, c0, rec_kernel, bias, activation="tanh"):
    """The fused LSTM recurrence (contract in the module docstring):
    ``LstmScan`` when autograd needs a gradient or under
    ``torch.func.vmap`` (whose tensors do not tell), else the forward
    alone."""
    args = (xproj, h0, c0, rec_kernel, bias)
    vmapped = any(torch._C._functorch.is_batchedtensor(x) for x in args)
    if vmapped or (torch.is_grad_enabled() and any(x.requires_grad for x in args)):
        y, h, c = LstmScan.apply(*args, activation)
        return y, (h, c)
    y, _, h, c = lstm_fwd(*args, activation)
    return y, (h, c)
