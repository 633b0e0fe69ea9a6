"""KTH action-video loader (OpenCV, imported at first use).

Counterpart of ``kccotgan_tpu/data/kth.py``, the same code: each sample
picks a random class folder and video, decodes its frames with OpenCV in
its BGR order (not converted to RGB, as in the reference), scales by
1/255, resizes (nearest) and centre-crops to (H, W), keeps frames with
``frame_id > start_after`` (5 for the fast classes or videos shorter than
350 frames, else 10), and yields the film-strip ``[H, T, W, 3]`` float32.
"""

from __future__ import annotations

import os
import random
from typing import Iterator

import numpy as np

__all__ = ["kth_samples"]

_FAST_CLASSES = ("running", "walking", "jogging")


def _resize_crop(frame: np.ndarray, height: int, width: int) -> np.ndarray:
    import cv2

    resized = cv2.resize(frame, (width, height), interpolation=cv2.INTER_NEAREST)
    h, w = resized.shape[:2]
    top = max((h - height) // 2, 0)
    left = max((w - width) // 2, 0)
    return resized[top : top + height, left : left + width]


def kth_samples(
    data_dir: str,
    batch_size: int,
    height: int = 64,
    width: int = 64,
    time_steps: int = 16,
    seed: int | None = None,
) -> Iterator[np.ndarray]:
    """Yield ``batch_size`` random videos per call, film-strip
    ``[H, T, W, 3]``.  ``data_dir`` contains per-class folders of video
    files; the caller selects the split directory (``kth/`` for train,
    ``kth_test/`` for test — reference `data_utils.py:163-166`)."""
    import cv2

    rng = random.Random(seed)
    classes = [
        d for d in os.listdir(data_dir) if os.path.isdir(os.path.join(data_dir, d))
    ]
    if not classes:
        raise FileNotFoundError(f"no class folders in {data_dir}")
    for _ in range(batch_size):
        cls = rng.choice(classes)
        folder = os.path.join(data_dir, cls)
        video_file = rng.choice(os.listdir(folder))
        cap = cv2.VideoCapture(os.path.join(folder, video_file))
        n_frames = cap.get(cv2.CAP_PROP_FRAME_COUNT)
        start_after = 5 if (cls in _FAST_CLASSES or n_frames < 350) else 10
        frames: list[np.ndarray] = []
        while cap.isOpened():
            frame_id = cap.get(cv2.CAP_PROP_POS_FRAMES)
            ret, frame = cap.read()
            if not ret or len(frames) >= time_steps:
                break
            if frame_id > start_after:
                frames.append(
                    _resize_crop(frame.astype(np.float32) / 255.0, height, width)
                )
        cap.release()
        if len(frames) < time_steps:
            continue
        clip = np.stack(frames[:time_steps])  # [T, H, W, 3]
        yield np.transpose(clip, (1, 0, 2, 3))  # film-strip [H, T, W, 3]
