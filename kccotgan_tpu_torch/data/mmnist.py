"""Moving-MNIST loader.

Counterpart of ``kccotgan_tpu/data/mmnist.py``: ``.npy`` files of shape
``[T_raw, N, 64, 64]`` (uint8 or float), scaled by 1/255, cut to
``total_time_steps`` and laid out as the film-strip ``[N, 64, T, 64, 1]``.
Pure numpy on the host; batching and the copy to the card live in
``pipeline.py``.
"""

from __future__ import annotations

import os

import numpy as np

__all__ = ["load_mmnist", "mmnist_paths"]


def mmnist_paths(root: str) -> tuple[str, str]:
    """``(train, test)`` paths of the MMNIST files under ``root``."""
    return (
        os.path.join(root, "mmnist", "mnist_training_set.npy"),
        os.path.join(root, "mmnist", "mnist_test_set.npy"),
    )


def load_mmnist(path: str, total_time_steps: int, *, mmap: bool = True) -> np.ndarray:
    """Load an MMNIST ``.npy`` as the film-strip ``[N, 64, T, 64, 1]``
    float32.  The file is memory-mapped and sliced to its first
    ``total_time_steps`` frames before anything is read."""
    raw = np.load(path, mmap_mode="r" if mmap else None)
    clip = np.asarray(raw[:total_time_steps])  # [T, N, H, W]
    clip = clip.astype(np.float32) / 255.0
    strip = np.transpose(clip, (1, 2, 0, 3))  # [N, H, T, W]
    return strip[..., None]
