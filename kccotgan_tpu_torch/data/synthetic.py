"""Synthetic video fixtures: bouncing-blob sequences shaped like MMNIST.

Counterpart of ``kccotgan_tpu/data/synthetic.py``, in numpy and equal to
it to the bit for the same arguments (``tests/test_torch_data.py``).
Used by the tests, ``chip_smoke.py`` and the CLI's ``--dname synthetic``,
so the whole training path runs with no download.
"""

from __future__ import annotations

import numpy as np

__all__ = ["bouncing_blobs", "write_mmnist_fixture"]


def bouncing_blobs(
    num_videos: int,
    time_steps: int,
    height: int = 64,
    width: int = 64,
    channels: int = 1,
    num_blobs: int = 2,
    blob_radius: int = 6,
    seed: int = 0,
) -> np.ndarray:
    """Film-strip ``[N, H, T, W, C]`` float32 in [0, 1] of blobs bouncing
    off the frame edges with constant velocity."""
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
            frame = np.clip(frame, 0.0, 1.0)
            out[n, :, t, :, 0] = frame
            pos += vel
            for b in range(num_blobs):
                for d, lim in ((0, height), (1, width)):
                    if pos[b, d] < blob_radius or pos[b, d] > lim - blob_radius:
                        vel[b, d] = -vel[b, d]
                        pos[b, d] = np.clip(pos[b, d], blob_radius, lim - blob_radius)
    if channels > 1:
        out = np.repeat(out, channels, axis=-1)[..., :channels]
    return out


def write_mmnist_fixture(path: str, num_videos: int = 16, time_steps: int = 20, seed: int = 0) -> None:
    """Write an MMNIST-layout ``.npy`` (``[T, N, 64, 64]`` uint8)."""
    strips = bouncing_blobs(num_videos, time_steps, seed=seed)  # [N, H, T, W, 1]
    raw = np.transpose(strips[..., 0], (2, 0, 1, 3))  # [T, N, H, W]
    np.save(path, (raw * 255).astype(np.uint8))
