"""TF 'SAME' convolution on NHWC tensors with HWIO kernels, shared by the
layers and the ConvLSTM recurrence's plain version."""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["same_conv"]


def _same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """TF/XLA 'SAME' padding ``(low, high)`` along one axis: the output
    is ``ceil(size / stride)`` and the odd pad goes on the high side."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def same_conv(x, kernel, strides, dtype=torch.float32, out_dtype=torch.float32):
    """NHWC conv with TF 'SAME' padding and an HWIO kernel.

    ``padding='same'`` in torch rejects stride > 1 and even kernels need
    asymmetric pads (k=6 at stride 2, k=4 and k=8 at stride 1), so the
    pads are explicit.  Inputs are cast to ``dtype`` and the result,
    accumulated by the conv in float32, is rounded to ``out_dtype``.
    """
    kh, kw = kernel.shape[0], kernel.shape[1]
    sh, sw = strides
    ph = _same_pads(x.shape[1], kh, sh)
    pw = _same_pads(x.shape[2], kw, sw)
    xc = F.pad(x.to(dtype).permute(0, 3, 1, 2), (*pw, *ph))
    out = F.conv2d(xc, kernel.to(dtype).permute(3, 2, 0, 1), stride=(sh, sw))
    return out.permute(0, 2, 3, 1).to(out_dtype)
