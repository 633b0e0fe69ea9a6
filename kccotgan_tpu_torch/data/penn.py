"""Penn Action loader (PIL, imported at first use).

Counterpart of ``kccotgan_tpu/data/penn.py``, the same code: each sample
picks a random folder of numbered JPEG frames, takes every frame if the
folder has fewer than ``2 * T``, else every second one, scales by 1/255,
centre-crops or pads to (H, W), and yields the film-strip
``[H, T, W, 3]`` float32.
"""

from __future__ import annotations

import os
import random
from typing import Iterator

import numpy as np

__all__ = ["penn_samples"]


def _crop_or_pad(img: np.ndarray, height: int, width: int) -> np.ndarray:
    h, w = img.shape[:2]
    out = np.zeros((height, width, img.shape[2]), dtype=img.dtype)
    top = max((h - height) // 2, 0)
    left = max((w - width) // 2, 0)
    crop = img[top : top + height, left : left + width]
    ot = max((height - crop.shape[0]) // 2, 0)
    ol = max((width - crop.shape[1]) // 2, 0)
    out[ot : ot + crop.shape[0], ol : ol + crop.shape[1]] = crop
    return out


def penn_samples(
    data_dir: str,
    batch_size: int,
    height: int = 128,
    width: int = 128,
    time_steps: int = 30,
    crop: bool = True,
    seed: int | None = None,
) -> Iterator[np.ndarray]:
    from PIL import Image

    rng = random.Random(seed)
    folders = [
        os.path.join(data_dir, d)
        for d in os.listdir(data_dir)
        if os.path.isdir(os.path.join(data_dir, d))
    ]
    if not folders:
        raise FileNotFoundError(f"no frame folders in {data_dir}")
    for _ in range(batch_size):
        folder = rng.choice(folders)
        jpgs = sorted(f for f in os.listdir(folder) if f.endswith(".jpg"))
        stride = 1 if len(jpgs) // 2 < time_steps else 2
        frames: list[np.ndarray] = []
        for name in jpgs[::stride]:
            if len(frames) >= time_steps:
                break
            img = np.asarray(
                Image.open(os.path.join(folder, name)).convert("RGB"),
                dtype=np.float32,
            ) / 255.0
            if crop:
                img = _crop_or_pad(img, height, width)
            frames.append(img)
        if len(frames) < time_steps:
            continue
        clip = np.stack(frames)  # [T, H, W, 3]
        yield np.transpose(clip, (1, 0, 2, 3))  # film-strip
