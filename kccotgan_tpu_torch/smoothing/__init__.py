"""Gaussian kernel smoothing (1d/2d/3d) and sigma annealing."""

from .gaussian import (
    annealing_sigma,
    apply_smoothing,
    gaussian_kernel1d,
    smooth_spatial,
    smooth_spatio_temporal,
    smooth_temporal,
    spatial_output_size,
)

__all__ = [
    "gaussian_kernel1d",
    "smooth_temporal",
    "smooth_spatial",
    "smooth_spatio_temporal",
    "annealing_sigma",
    "apply_smoothing",
    "spatial_output_size",
]
