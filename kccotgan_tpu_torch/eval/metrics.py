"""Video-prediction metrics: per-frame PSNR and SSIM.

Counterpart of ``kccotgan_tpu/eval/metrics.py`` (``psnr``, ``ssim``,
``video_metrics``), with ``tf.image``'s semantics: MSE over (H, W, C)
for PSNR; for SSIM an 11x11 Gaussian window of sigma 1.5, k1 = 0.01,
k2 = 0.03, VALID padding, the luminance times contrast-structure map
clipped to [-1, 1] (the JAX package's guard against the cancellation in
E[x^2] - E[x]^2 on flat windows), then its mean.  The window is applied
as two depthwise 1-D convolutions (``F.conv2d`` with one group a
channel).  Videos are film-strips ``[B, H, T, W, C]`` in [0, max_val];
results are float32 on the videos' device.  ``best_of_k`` scores K
rollouts of one context and keeps each sample's best (the stochastic
video-prediction protocol).
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F

__all__ = ["best_of_k", "psnr", "ssim", "video_metrics"]


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


def best_of_k(
    rollout: Callable[..., torch.Tensor],
    params,
    test_batch: torch.Tensor,
    int_time_steps: int,
    generator: torch.Generator | None,
    *,
    k: int = 1,
    max_val: float = 1.0,
) -> dict:
    """Best-of-K stochastic-prediction evaluation.

    Draws ``k`` rollouts ``rollout(params, context, generator)`` (the
    ``train.rollout.build_rollout`` signature) one after the other, their
    noise from the one ``generator`` in sequence (where the JAX package
    splits a key into ``k``), scores each sample's predicted future
    against the ground-truth future, and keeps the per-sample best.
    ``test_batch`` is a full-length film-strip ``[B, H, Tc + Tp, W, C]``;
    when the rollout generates fewer frames than it carries, the common
    horizon is scored.  A later rollout replaces a sample's best only if
    strictly better.

    Returns the scalar means of the per-sample-best PSNR and SSIM, and
    the per-step curves of the PSNR-best and of the SSIM-best rollouts,
    each chosen by its own metric.
    """
    context = test_batch[:, :, :int_time_steps]
    truth = test_batch[:, :, int_time_steps:]
    t_pred = truth.shape[2]
    best_ps = best_ss = best_ps_curve = best_ss_curve = None
    for _ in range(k):
        video = rollout(params, context, generator)
        t_pred = min(t_pred, video.shape[2] - int_time_steps)
        truth = truth[:, :, :t_pred]
        pred = video[:, :, int_time_steps : int_time_steps + t_pred]
        ps = psnr(pred, truth, max_val=max_val)  # [B, Tp]
        ss = ssim(pred, truth, max_val=max_val)
        ps_mean, ss_mean = torch.mean(ps, dim=1), torch.mean(ss, dim=1)
        if best_ps is None:
            best_ps, best_ss, best_ps_curve, best_ss_curve = ps_mean, ss_mean, ps, ss
            continue
        improve = ps_mean > best_ps
        best_ps_curve = torch.where(improve[:, None], ps, best_ps_curve)
        best_ps = torch.maximum(best_ps, ps_mean)
        improve_s = ss_mean > best_ss
        best_ss_curve = torch.where(improve_s[:, None], ss, best_ss_curve)
        best_ss = torch.maximum(best_ss, ss_mean)
    return {
        "psnr": torch.mean(best_ps),
        "ssim": torch.mean(best_ss),
        "psnr_per_step": torch.mean(best_ps_curve, dim=0),
        "ssim_per_step": torch.mean(best_ss_curve, dim=0),
    }
