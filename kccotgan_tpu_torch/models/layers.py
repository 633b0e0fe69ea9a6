"""PyTorch layers with the semantics of ``kccotgan_tpu.models.layers``.

Tensors keep the JAX package's layouts at every public boundary: NHWC
images, ``[B, T, H, W, C]`` sequences, HWIO conv kernels and the Keras
``(kh, kw, filters, in)`` ConvTranspose kernel, so parameters port 1:1
and tests compare like with like.  Each layer rounds where the JAX layer
rounds: convolutions take their inputs in the compute dtype and hand
back ``out_dtype``; the ConvLSTM carry and gate math stay float32.

``ConvLSTM2D`` and ``LSTM`` choose their recurrence engine as the JAX
layers do under ``kernel_impl``: the fused recurrence (``convlstm_scan``,
``lstm_scan``: the Hopper kernels for CUDA tensors, under autograd
through their backward kernels) unless ``plain`` is set, which runs the
plain loop under autograd (the ``'scan'`` engine, and the kernels'
reference).  Keras dropout (``ConvLSTM2D``'s ``dropout`` and
``recurrent_dropout``, masks only in training) stays on the chosen
engine: the input masks change only the hoisted input conv, and the
recurrence takes the recurrent masks (the kernels' masked mode).  With
``seq_axis`` (a process group) the input is a chunk of a sequence split
over the group's ranks and the recurrence runs as a ring relay
(``parallel/seqpar.py::time_sharded_scan``) on the same engine.
``BatchNorm`` with a ``group`` takes its batch statistics over the
group's ranks.  The other layers are plain PyTorch.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.comm import all_reduce_sum
from ..parallel.seqpar import time_sharded_scan
from .conv import same_conv
from .cuda_convlstm import convlstm_scan, convlstm_scan_reference
from .cuda_lstm import lstm_scan, lstm_scan_reference

__all__ = [
    "LSTM", "BatchNorm", "Conv2D", "ConvLSTM2D", "ConvTranspose2D", "LayerNorm", "bernoulli_source",
    "leaky_relu",
]

_ACTIVATIONS = {"tanh": torch.tanh, "sigmoid": torch.sigmoid}


def _torch_dtype(name: str) -> torch.dtype:
    if name == "bfloat16":
        return torch.bfloat16
    if name == "float32":
        return torch.float32
    raise ValueError(f"unsupported compute_dtype: {name!r}")


class LayerNorm(nn.Module):
    """flax ``LayerNorm`` over the last axis, with its fast variance
    ``max(E[x^2] - E[x]^2, 0)`` so the port rounds as flax does."""

    def __init__(self, features: int, eps: float = 1e-3):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))

    def reset_parameters(self, generator: torch.Generator) -> None:
        del generator
        nn.init.ones_(self.scale)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        mu = x.mean(-1, keepdim=True)
        var = ((x * x).mean(-1, keepdim=True) - mu * mu).clamp_min(0.0)
        return (x - mu) * (torch.rsqrt(var + self.eps) * self.scale) + self.bias


def bernoulli_source(generator: torch.Generator):
    """A mask source, ``draw(keep_prob, shape) -> 0/1 float32 tensor``,
    drawing every mask from ``generator`` on its device."""

    def draw(keep_prob: float, shape):
        return torch.empty(shape, device=generator.device).bernoulli_(keep_prob, generator=generator)

    return draw


def _glorot_uniform_(w, fan_in: int, fan_out: int, generator):
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        w.uniform_(-limit, limit, generator=generator)


class ConvLSTM2D(nn.Module):
    """Keras-semantics ConvLSTM2D, input conv hoisted.

    ``forward(x [B, T, H, W, C] f32)`` returns ``(y [B, T, H', W', f]
    f32, (h, c) f32)`` with ``H' = ceil(H / stride)``.  The input conv
    over all T frames runs once and streams in the compute dtype; the
    recurrence (recurrent conv, bias, Keras gates [i, f, c, o]) is
    ``convlstm_scan``, which launches the Hopper kernels for CUDA tensors
    (forward, and backward under autograd) and runs their plain versions
    on the CPU.  ``plain=True`` runs the plain loop on any device, which
    autograd differentiates: the kernels' reference on the card, and the
    training step's recurrence under ``kernel_impl='scan'``.

    Keras dropout, with ``training=True`` and a mask source ``masks``
    (``bernoulli_source``): four input masks ``[B, H, W, C]`` and four
    recurrent masks ``[B, H', W', f]``, one a gate, each ``bernoulli(1 -
    p) / (1 - p)`` and shared across time, drawn in that order.  Gate g's
    input conv reads ``x * in_mask[g]`` and its recurrent conv ``h_{t-1}
    * rec_mask[g]``.  The engine stays the one ``plain`` chose: the masked
    input convs form the recurrence's ``xconv``, and the recurrent masks
    go to ``convlstm_scan``, whose kernels take them (where the JAX layer
    under ``'pallas'`` runs ``lax.scan`` instead).

    ``seq_axis``: a process group over whose ranks the sequence is split;
    ``x_seq`` is then this rank's chunk of frames, the recurrence a ring
    relay from the previous rank's carry, and the returned state the
    carry after the sequence's last frame, on every rank.  The masks are
    drawn per rank and must be the same on every rank of the group.
    """

    def __init__(
        self,
        in_channels: int,
        filters: int,
        kernel_size: tuple[int, int],
        strides: tuple[int, int] = (1, 1),
        use_bias: bool = True,
        compute_dtype: str = "float32",
        dropout: float = 0.0,
        recurrent_dropout: float = 0.0,
        seq_axis: str | None = None,
        plain: bool = False,
        name: str | None = None,
    ):
        super().__init__()
        self.plain = plain
        self.seq_axis = seq_axis
        kh, kw = kernel_size
        self.filters = filters
        self.strides = tuple(strides)
        self.dropout = dropout
        self.recurrent_dropout = recurrent_dropout
        self.name = name
        self.cdt = _torch_dtype(compute_dtype)
        self.kernel = nn.Parameter(torch.empty(kh, kw, in_channels, 4 * filters))
        self.recurrent_kernel = nn.Parameter(torch.empty(kh, kw, filters, 4 * filters))
        self.bias = nn.Parameter(torch.empty(4 * filters)) if use_bias else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        """glorot-uniform kernel, orthogonal recurrent kernel over its
        ``[kh*kw*f, 4f]`` matrix, unit forget bias (as flax/Keras)."""
        kh, kw, c, f4 = self.kernel.shape
        _glorot_uniform_(self.kernel, kh * kw * c, kh * kw * f4, generator)
        rk = self.recurrent_kernel
        with torch.no_grad():
            mat = torch.empty(rk.numel() // f4, f4, device=rk.device)
            nn.init.orthogonal_(mat, generator=generator)
            rk.copy_(mat.reshape(rk.shape))
            if self.bias is not None:
                self.bias.zero_()
                self.bias[self.filters : 2 * self.filters] = 1.0

    def forward(self, x_seq, initial_state=None, training=False, masks=None):
        b, t, h, w, c = x_seq.shape
        f = self.filters
        in_p = self.dropout if training else 0.0
        rec_p = self.recurrent_dropout if training else 0.0
        if (in_p > 0.0 or rec_p > 0.0) and masks is None:
            raise ValueError(
                f"ConvLSTM2D {self.name or '<unnamed>'}: dropout in training needs a mask source"
            )
        if in_p > 0.0:
            keep = 1.0 - in_p
            in_masks = [masks(keep, (b, h, w, c)) / keep for _ in range(4)]
            # One conv a gate over its masked input.  Rounded once to the
            # compute dtype, as the JAX layer's f32-typed result holds.
            xconv = torch.cat([
                same_conv(
                    (x_seq * m[:, None]).reshape(b * t, h, w, c), self.kernel[..., g * f : (g + 1) * f],
                    self.strides, self.cdt, out_dtype=self.cdt,
                )
                for g, m in enumerate(in_masks)
            ], dim=-1)
        else:
            xconv = same_conv(
                x_seq.reshape(b * t, h, w, c), self.kernel, self.strides, self.cdt, out_dtype=self.cdt
            )
        ho, wo = xconv.shape[1], xconv.shape[2]
        # The kernels take a C-contiguous stack.  An input in NCHW strides
        # (a generated RGB frame fed back in the rollout) gives the conv
        # an NCHW output, which the NHWC view leaves strided.
        xconv = xconv.reshape(b, t, ho, wo, 4 * f).contiguous()
        rec_masks = None
        if rec_p > 0.0:
            keep = 1.0 - rec_p
            rec_masks = torch.stack([masks(keep, (b, ho, wo, f)) / keep for _ in range(4)])
        if initial_state is None:
            h0 = x_seq.new_zeros(b, ho, wo, f, dtype=torch.float32)
            c0 = torch.zeros_like(h0)
        else:
            h0, c0 = initial_state
        bias = self.bias if self.bias is not None else xconv.new_zeros(
            4 * f, dtype=torch.float32
        )
        engine = convlstm_scan_reference if self.plain else convlstm_scan

        def scan(xs, h, c, rk, b):
            return engine(xs, h, c, rk, b, rec_masks)

        y, state = time_sharded_scan(scan, xconv, h0, c0, self.recurrent_kernel, bias,
                                     group=self.seq_axis, name=self.name or "convlstm")
        return y.float(), state


class ConvTranspose2D(nn.Module):
    """Transposed conv with TF/Keras 'SAME' semantics (``out = in *
    stride``), no bias.  Computed as in JAX: flip the taps, swap in and
    out, dilate the input by the stride and run a stride-1 conv.
    """

    def __init__(
        self,
        in_channels: int,
        filters: int,
        kernel_size: tuple[int, int],
        strides: tuple[int, int] = (1, 1),
        activation: str | None = None,
        compute_dtype: str = "float32",
    ):
        super().__init__()
        kh, kw = kernel_size
        self.strides = tuple(strides)
        self.activation = activation
        self.cdt = _torch_dtype(compute_dtype)
        self.kernel = nn.Parameter(torch.empty(kh, kw, filters, in_channels))

    def reset_parameters(self, generator: torch.Generator) -> None:
        kh, kw, f, c = self.kernel.shape
        _glorot_uniform_(self.kernel, kh * kw * f, kh * kw * c, generator)

    def forward(self, x):
        kh, kw = self.kernel.shape[0], self.kernel.shape[1]
        sh, sw = self.strides
        n, h, w, c = x.shape
        # [kh, kw, filters, in] -> flipped OIHW [filters, in, kh, kw]
        k = torch.flip(self.kernel, (0, 1)).permute(2, 3, 0, 1).to(self.cdt)
        xd = x.new_zeros(n, c, (h - 1) * sh + 1, (w - 1) * sw + 1, dtype=self.cdt)
        xd[:, :, ::sh, ::sw] = x.to(self.cdt).permute(0, 3, 1, 2)

        def pad_for(ksize, stride):
            # forward-'SAME' total pad for out = in * s is k - s
            total = max(ksize - stride, 0)
            return ksize - 1 - total // 2, ksize - 1 - (total - total // 2)

        out = F.conv2d(F.pad(xd, (*pad_for(kw, sw), *pad_for(kh, sh))), k)
        out = out.permute(0, 2, 3, 1).float()
        if self.activation is not None:
            out = _ACTIVATIONS[self.activation](out)
        return out


def leaky_relu(x, negative_slope: float = 0.3):
    """Keras LeakyReLU (slope 0.3) as ``where(x >= 0, x, slope * x)``: its
    gradient at 0 is 1, where ``F.leaky_relu``'s is the slope."""
    return torch.where(x >= 0, x, negative_slope * x)


class Conv2D(nn.Module):
    """TF-'SAME' Conv2D on ``[N, H, W, C]`` with an HWIO kernel and an f32
    bias; inputs in the compute dtype, result f32."""

    def __init__(
        self,
        in_channels: int,
        filters: int,
        kernel_size: tuple[int, int],
        strides: tuple[int, int] = (1, 1),
        compute_dtype: str = "float32",
    ):
        super().__init__()
        kh, kw = kernel_size
        self.strides = tuple(strides)
        self.cdt = _torch_dtype(compute_dtype)
        self.kernel = nn.Parameter(torch.empty(kh, kw, in_channels, filters))
        self.bias = nn.Parameter(torch.empty(filters))

    def reset_parameters(self, generator: torch.Generator) -> None:
        kh, kw, c, f = self.kernel.shape
        _glorot_uniform_(self.kernel, kh * kw * c, kh * kw * f, generator)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        return same_conv(x, self.kernel, self.strides, self.cdt) + self.bias


class BatchNorm(nn.Module):
    """flax ``BatchNorm`` with the discriminator's momentum 0.99 and eps
    1e-3, written out (``torch.nn``'s differs in layout, momentum
    convention and running variance).

    ``forward(x, mean, var)`` normalizes over every axis but the last
    (``[N, H, W, C]`` and ``[B, T, U]`` alike) with the batch's statistics,
    the fast variance ``max(E[x^2] - E[x]^2, 0)`` in f32, and returns
    ``(y, (mean', var'))`` with the running statistics
    ``momentum * old + (1 - momentum) * batch`` (biased variance), which
    carry no gradient.  With ``training=False`` (flax's
    ``use_running_average=True``) it normalizes by ``mean`` and ``var``
    and returns them unchanged.  Under ``torch.func.vmap`` each instance
    is normalized by its own batch, as vmapped flax does.

    ``group``: the batch is split over the group's ranks, and ``E[x]``
    and ``E[x^2]`` are those of the whole: this rank's sums and row count
    summed over the group (``all_reduce_sum``, one call, whose backward
    sums the gradients too), so every rank normalizes by the global
    batch's statistics and keeps the same running ones.
    """

    momentum = 0.99
    eps = 1e-3

    def __init__(self, features: int, group=None):
        super().__init__()
        self.group = group
        self.scale = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))

    def reset_parameters(self, generator: torch.Generator) -> None:
        del generator
        nn.init.ones_(self.scale)
        nn.init.zeros_(self.bias)

    def forward(self, x, mean, var, training=True):
        if not training:
            return (x - mean) * (torch.rsqrt(var + self.eps) * self.scale) + self.bias, (mean, var)
        dims = tuple(range(x.dim() - 1))
        if self.group is None:
            mu = x.mean(dims)
            ex2 = (x * x).mean(dims)
        else:
            rows = x.new_full((1,), float(x.numel() // x.shape[-1]))
            sums = all_reduce_sum(torch.cat([x.sum(dims), (x * x).sum(dims), rows]), self.group)
            c = x.shape[-1]
            mu, ex2 = sums[:c] / sums[-1], sums[c : 2 * c] / sums[-1]
        batch_var = (ex2 - mu * mu).clamp_min(0.0)
        y = (x - mu) * (torch.rsqrt(batch_var + self.eps) * self.scale) + self.bias
        m = self.momentum
        new_mean = m * mean + (1.0 - m) * mu.detach()
        new_var = m * var + (1.0 - m) * batch_var.detach()
        return y, (new_mean, new_var)


class LSTM(nn.Module):
    """Keras-semantics dense LSTM over ``[B, T, F]`` -> ``[B, T, units]`` f32.

    The input projection is hoisted to one ``[B*T, F] @ [F, 4U]`` product in
    the compute dtype; each step adds ``(x_t + bias) + h @ R`` in f32 (the
    recurrent product rounded to the compute dtype and back), applies the
    Keras gates [i, f, c, o] and rounds its output to the compute dtype.
    The recurrence is ``lstm_scan`` (the Hopper kernels for CUDA tensors,
    their plain versions on the CPU), or with ``plain=True`` the plain
    loop under autograd (the JAX package's ``lax.scan``).  ``seq_axis``:
    as ``ConvLSTM2D``'s, a ring relay over the group's ranks.
    """

    def __init__(
        self,
        in_features: int,
        units: int,
        activation: str = "tanh",
        compute_dtype: str = "float32",
        plain: bool = False,
        seq_axis=None,
        name: str = "lstm",
    ):
        super().__init__()
        if activation not in _ACTIVATIONS:
            raise ValueError(f"LSTM: unsupported activation {activation!r}")
        self.seq_axis = seq_axis
        self.name = name
        self.units = units
        self.activation = activation
        self.plain = plain
        self.cdt = _torch_dtype(compute_dtype)
        self.kernel = nn.Parameter(torch.empty(in_features, 4 * units))
        self.recurrent_kernel = nn.Parameter(torch.empty(units, 4 * units))
        self.bias = nn.Parameter(torch.empty(4 * units))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """glorot-uniform kernel, orthogonal recurrent kernel, unit forget
        bias (as flax/Keras)."""
        f, u4 = self.kernel.shape
        _glorot_uniform_(self.kernel, f, u4, generator)
        with torch.no_grad():
            nn.init.orthogonal_(self.recurrent_kernel, generator=generator)
            self.bias.zero_()
            self.bias[self.units : 2 * self.units] = 1.0

    def forward(self, x_seq):
        b, t, feat = x_seq.shape
        u, cdt = self.units, self.cdt
        xproj = (x_seq.reshape(b * t, feat).to(cdt) @ self.kernel.to(cdt)).reshape(b, t, 4 * u)
        h0 = x_seq.new_zeros(b, u, dtype=torch.float32)
        c0 = torch.zeros_like(h0)
        args = (xproj, h0, c0, self.recurrent_kernel, self.bias, self.activation)
        if self.seq_axis is None:
            y = lstm_scan_reference(*args)[0] if self.plain else lstm_scan(*args)[0]
            return y.float()

        def scan(xs, h, c, rk, b):
            if self.plain:
                ys, _, hn, cn = lstm_scan_reference(xs, h, c, rk, b, self.activation)
                return ys, (hn, cn)
            return lstm_scan(xs, h, c, rk, b, self.activation)

        y, _ = time_sharded_scan(scan, *args[:5], group=self.seq_axis, name=self.name)
        return y.float()
