"""Video-prediction metrics: per-frame PSNR and SSIM.

Counterpart of ``kccotgan_tpu/eval/metrics.py`` (``psnr``, ``ssim``,
``video_metrics``), with ``tf.image``'s semantics: MSE over (H, W, C)
for PSNR; for SSIM an 11x11 Gaussian window of sigma 1.5, k1 = 0.01,
k2 = 0.03, VALID padding, the luminance times contrast-structure map
clipped to [-1, 1] (the JAX package's guard against the cancellation in
E[x^2] - E[x]^2 on flat windows), then its mean.  The window is applied
as two depthwise 1-D convolutions (``F.conv2d`` with one group a
channel).  Videos are film-strips ``[B, H, T, W, C]`` in [0, max_val];
results are float32 on the videos' device.  ``best_of_k`` waits for
``cli/sample.py`` (ROADMAP Queue 1 item 4).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = ["psnr", "ssim", "video_metrics"]


def _frames(video: torch.Tensor) -> torch.Tensor:
    """Film-strip ``[B, H, T, W, C]`` -> frames ``[B * T, C, H, W]`` float32."""
    b, h, t, w, c = video.shape
    return video.float().permute(0, 2, 4, 1, 3).reshape(b * t, c, h, w)


def psnr(pred: torch.Tensor, target: torch.Tensor, *, max_val: float = 1.0) -> torch.Tensor:
    """Per-frame PSNR (dB) of two film-strips -> ``[B, T]``:
    ``10 * log10(max_val^2 / MSE)``, MSE over (H, W, C)."""
    mse = torch.mean(torch.square(pred.float() - target.float()), dim=(1, 3, 4))
    return 10.0 * (2.0 * math.log10(max_val) - torch.log10(mse))


def _gaussian_window(size: int, sigma: float, device) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    g = torch.exp(-torch.square(x) / (2.0 * sigma * sigma))
    return g / torch.sum(g)


def _blur(frames: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """Separable VALID Gaussian blur of ``[N, C, H, W]``, one group a channel."""
    c, k = frames.shape[1], window.shape[0]
    out = F.conv2d(frames, window.view(1, 1, k, 1).expand(c, 1, k, 1), groups=c)
    return F.conv2d(out, window.view(1, 1, 1, k).expand(c, 1, 1, k), groups=c)


def ssim(
    pred: torch.Tensor,
    target: torch.Tensor,
    *,
    max_val: float = 1.0,
    filter_size: int = 11,
    filter_sigma: float = 1.5,
    k1: float = 0.01,
    k2: float = 0.03,
) -> torch.Tensor:
    """Per-frame SSIM of two film-strips -> ``[B, T]``."""
    b, t = pred.shape[0], pred.shape[2]
    x, y = _frames(pred), _frames(target)
    window = _gaussian_window(filter_size, filter_sigma, x.device)
    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2

    mx, my = _blur(x, window), _blur(y, window)
    num0 = 2.0 * mx * my
    den0 = torch.square(mx) + torch.square(my)
    luminance = (num0 + c1) / (den0 + c1)
    num1 = 2.0 * _blur(x * y, window)
    den1 = _blur(torch.square(x), window) + _blur(torch.square(y), window)
    cs = (num1 - num0 + c2) / (den1 - den0 + c2)
    per_frame = torch.mean(torch.clamp(luminance * cs, -1.0, 1.0), dim=(1, 2, 3))
    return per_frame.reshape(b, t)


def video_metrics(pred: torch.Tensor, target: torch.Tensor, *, max_val: float = 1.0) -> dict:
    """``{"psnr", "ssim"}`` as means over batch and time, and
    ``{"psnr_per_step", "ssim_per_step"}`` as ``[T]`` curves."""
    ps = psnr(pred, target, max_val=max_val)
    ss = ssim(pred, target, max_val=max_val)
    return {
        "psnr": torch.mean(ps),
        "ssim": torch.mean(ss),
        "psnr_per_step": torch.mean(ps, dim=0),
        "ssim_per_step": torch.mean(ss, dim=0),
    }
