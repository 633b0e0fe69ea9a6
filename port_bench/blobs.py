"""Bouncing-blob videos shaped like Moving MNIST: the benchmark's frozen
copy of the port's ``data/synthetic.py::bouncing_blobs``, so that the
inputs stay the same whatever later changes make to the program."""

from __future__ import annotations

import numpy as np

__all__ = ["bouncing_blobs"]


def bouncing_blobs(num_videos: int, time_steps: int, height: int = 64, width: int = 64, channels: int = 1,
                   num_blobs: int = 2, blob_radius: int = 6, seed: int = 0) -> np.ndarray:
    """Film-strips ``[N, H, T, W, C]`` float32 in [0, 1] of Gaussian blobs
    moving at constant velocity and bouncing off the frame's edges."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    out = np.zeros((num_videos, height, time_steps, width, channels), np.float32)
    for n in range(num_videos):
        pos = rng.uniform(blob_radius, [height - blob_radius, width - blob_radius], (num_blobs, 2)).astype(np.float32)
        vel = rng.uniform(-3, 3, (num_blobs, 2)).astype(np.float32)
        for t in range(time_steps):
            frame = np.zeros((height, width), np.float32)
            for b in range(num_blobs):
                d2 = (yy - pos[b, 0]) ** 2 + (xx - pos[b, 1]) ** 2
                frame += np.exp(-d2 / (2.0 * blob_radius**2))
            out[n, :, t, :, 0] = np.clip(frame, 0.0, 1.0)
            pos += vel
            for b in range(num_blobs):
                for d, lim in ((0, height), (1, width)):
                    if pos[b, d] < blob_radius or pos[b, d] > lim - blob_radius:
                        vel[b, d] = -vel[b, d]
                        pos[b, d] = np.clip(pos[b, d], blob_radius, lim - blob_radius)
    if channels > 1:
        out = np.repeat(out, channels, axis=-1)[..., :channels]
    return out
