"""Gaussian kernel smoothing of video batches (1d/2d/3d) and sigma
annealing: the "K" of KCCOT-GAN, applied to the real and the generated
video before the discriminators and the causal-OT cost.

Counterpart of ``kccotgan_tpu/smoothing/gaussian.py``, with its names
and semantics:

* ``'1d'`` (``smooth_temporal``): a Gaussian over T with REFLECT padding
  (the edge frame is not repeated), applied as a ``[T, T]`` band matrix
  contracted against the time axis;
* ``'2d'`` (``smooth_spatial``): a separable Gaussian over (H, W) with
  VALID padding, so H and W shrink by ``2 * radius``
  (``spatial_output_size``);
* ``'3d'`` (``smooth_spatio_temporal``): the temporal band, then the
  spatial passes over REFLECT-padded frames, all with the spatial
  radius; a Gaussian is separable, so this equals the dense k^3 kernel;
* every mode divides by the smoothed batch's global maximum, which
  couples the samples of a batch (its gradient splits evenly among
  ties, as ``amax``'s does); with ``group`` the batch's rows are split
  over the group's ranks and the maximum is the whole batch's
  (``parallel.comm.global_amax``);
* ``annealing_sigma``: ``sigma * 0.975 ** (step / 500)``, in float32 on
  the host.

Videos are film-strips ``[B, H, T, W, C]``; every result is float32.
These are torch ops (a matmul and ``F.conv2d``): the JAX package runs
them as XLA ops, not as a kernel of its own.  The taps and the band of a
(radius, sigma, T) are made once and kept (``_taps``, ``_band``): a
training step smooths three times at one sigma.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel.comm import global_amax

__all__ = [
    "gaussian_kernel1d",
    "smooth_temporal",
    "smooth_spatial",
    "smooth_spatio_temporal",
    "annealing_sigma",
    "apply_smoothing",
    "spatial_output_size",
]

DEFAULT_TEMPORAL_KERNEL = 6
DEFAULT_SPATIAL_KERNEL = 6


def gaussian_kernel1d(radius: int, sigma: float, device=None) -> torch.Tensor:
    """Normalized float32 Gaussian taps of length ``2 * radius + 1``.

    ``sigma`` is a host number, taken as float32: the coefficient
    ``-0.5 / sigma**2`` is rounded as in float32 arithmetic, and the taps
    are computed on ``device`` without a host round trip."""
    s = np.float32(sigma)
    coef = float(np.float32(-0.5) / (s * s))
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    k = torch.exp(x * coef * x)
    return k / k.sum()


def _reflect_band_matrix(t: int, radius: int, taps: torch.Tensor) -> torch.Tensor:
    """The ``[T, T]`` matrix of the REFLECT-padded 1-D conv with ``taps``.

    Row ``s`` holds tap ``d`` at input time ``reflect(s + d)``, ``d`` in
    ``[-radius, radius]``: index ``-k`` reflects to ``k`` and ``t-1+k``
    to ``t-1-k``.  Taps that fold onto one column add up in the order of
    ``d``, as the JAX package's scatter-add sums them, and in a fixed
    order on any device.  Where the radius reaches past a short T the
    reflected index can still be negative; as in that scatter, such an
    index counts from the end once (``-1`` is ``t-1``), and one still
    out of range drops its tap.
    """
    dev = taps.device
    cols = torch.arange(t, device=dev)
    idx = (cols[:, None] + torch.arange(-radius, radius + 1, device=dev)[None, :]).abs()
    idx = torch.where(idx > t - 1, 2 * (t - 1) - idx, idx)
    idx = torch.where(idx < 0, idx + t, idx)
    hits = idx[:, :, None] == cols[None, None, :]  # [T_out, taps, T_in]
    band = torch.zeros(t, t, dtype=taps.dtype, device=dev)
    for j in range(2 * radius + 1):
        band = band + torch.where(hits[:, j], taps[j], 0.0)
    return band


@functools.lru_cache(maxsize=16)
def _taps(radius: int, sigma: float, device: torch.device) -> torch.Tensor:
    """``gaussian_kernel1d``, made once a (radius, sigma, device)."""
    return gaussian_kernel1d(radius, sigma, device)


@functools.lru_cache(maxsize=16)
def _band(t: int, radius: int, sigma: float, device: torch.device) -> torch.Tensor:
    """``_reflect_band_matrix`` of ``_taps``, made once a (T, radius,
    sigma, device)."""
    return _reflect_band_matrix(t, radius, _taps(radius, sigma, device))


def _temporal_band(video: torch.Tensor, radius: int, sigma: float) -> torch.Tensor:
    """``video`` contracted over T against the band matrix, in float32."""
    band = _band(video.shape[2], radius, float(sigma), video.device)  # [T_out, T_in]
    return torch.einsum("bhtwc,st->bhswc", video.float(), band)


def _normalized(out, group):
    return out / (out.amax() if group is None else global_amax(out, group))


def smooth_temporal(video, sigma, *, kernel_size: int = DEFAULT_TEMPORAL_KERNEL, group=None):
    """1-D temporal Gaussian smoothing, REFLECT padded, max-normalized."""
    return _normalized(_temporal_band(video, kernel_size // 2, sigma), group)


def _conv_sep_spatial(frames: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """Separable (H then W) VALID conv of ``[N, 1, H, W]`` frames."""
    k = taps.shape[0]
    out = F.conv2d(frames, taps.view(1, 1, k, 1))
    return F.conv2d(out, taps.view(1, 1, 1, k))


def _frames(video: torch.Tensor) -> torch.Tensor:
    """``[B, H, T, W, C]`` -> one-channel frames ``[B*T*C, 1, H, W]``."""
    b, h, t, w, c = video.shape
    return video.permute(0, 2, 4, 1, 3).reshape(b * t * c, 1, h, w)


def _unframes(frames: torch.Tensor, b: int, t: int, c: int) -> torch.Tensor:
    """Inverse of ``_frames`` for frames of any size."""
    ho, wo = frames.shape[2], frames.shape[3]
    return frames.reshape(b, t, c, ho, wo).permute(0, 3, 1, 4, 2)


def _reflect_pad(frames: torch.Tensor, radius: int) -> torch.Tensor:
    """REFLECT padding of H and W by ``radius`` (the edge is not repeated,
    as ``jnp.pad(mode="reflect")``), built from flipped slices so that
    its gradient sums in a fixed order on any device."""
    for dim in (2, 3):
        n = frames.shape[dim]
        lo = frames.narrow(dim, 1, radius).flip(dim)
        hi = frames.narrow(dim, n - 1 - radius, radius).flip(dim)
        frames = torch.cat([lo, frames, hi], dim)
    return frames


def spatial_output_size(size: int, kernel_size: int = DEFAULT_SPATIAL_KERNEL) -> int:
    """H or W after VALID spatial smoothing (shrinks by 2 * radius)."""
    return size - 2 * (kernel_size // 2)


def smooth_spatial(video, sigma, *, kernel_size: int = DEFAULT_SPATIAL_KERNEL, group=None):
    """Separable 2-D spatial Gaussian, VALID padding (H and W shrink),
    max-normalized; each channel is smoothed on its own."""
    b, _, t, _, c = video.shape
    taps = _taps(kernel_size // 2, float(sigma), video.device)
    return _normalized(_unframes(_conv_sep_spatial(_frames(video.float()), taps), b, t, c), group)


def smooth_spatio_temporal(video, sigma, *, kernel_size: int = DEFAULT_SPATIAL_KERNEL, group=None):
    """3-D (T, H, W) Gaussian with REFLECT padding, max-normalized: the
    temporal band, then the two spatial passes over frames REFLECT-padded
    by the radius, every axis with ``kernel_size``'s radius."""
    radius = kernel_size // 2
    b, _, t, _, c = video.shape
    frames = _reflect_pad(_frames(_temporal_band(video, radius, sigma)), radius)
    out = _unframes(_conv_sep_spatial(frames, _taps(radius, float(sigma), video.device)), b, t, c)
    return _normalized(out, group)


def annealing_sigma(init_sigma, step: int, decay_steps: int = 500, decay_rate: float = 0.975) -> float:
    """``init_sigma * decay_rate ** (step / decay_steps)``, continuous (not
    staircase), in float32 arithmetic on the host from an integer step."""
    f32 = np.float32
    return float(f32(init_sigma) * f32(decay_rate) ** (f32(step) / f32(decay_steps)))


def apply_smoothing(
    video,
    sigma,
    mode: str = "none",
    *,
    temporal_kernel: int = DEFAULT_TEMPORAL_KERNEL,
    spatial_kernel: int = DEFAULT_SPATIAL_KERNEL,
    group=None,
):
    """Dispatch on the trainer's ``kernel`` option: ``'1d'``, ``'2d'``,
    ``'3d'`` or ``'none'`` (the video as it is); ``group`` as in the
    module docstring."""
    if mode == "none":
        return video
    if mode == "1d":
        return smooth_temporal(video, sigma, kernel_size=temporal_kernel, group=group)
    if mode == "2d":
        return smooth_spatial(video, sigma, kernel_size=spatial_kernel, group=group)
    if mode == "3d":
        return smooth_spatio_temporal(video, sigma, kernel_size=spatial_kernel, group=group)
    raise ValueError(f"unknown smoothing mode: {mode!r}")
