"""Quantitative video-prediction metrics."""

from .metrics import best_of_k, psnr, ssim, video_metrics

__all__ = ["best_of_k", "psnr", "ssim", "video_metrics"]
