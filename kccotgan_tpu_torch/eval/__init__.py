"""Quantitative video-prediction metrics."""

from .metrics import psnr, ssim, video_metrics

__all__ = ["psnr", "ssim", "video_metrics"]
