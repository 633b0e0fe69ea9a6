"""BAIR robot-push (softmotion30_44k) loader.

Counterpart of ``kccotgan_tpu/data/bair.py``, the same code: TFRecord
files of ``tf.train.SequenceExample``s whose *context* holds, for each
frame ``i``, ``{i}/image_aux1/encoded`` as raw 64x64x3 uint8 bytes (not
JPEG), read over the sorted shards of ``train/`` or ``test/``.  Each
video yields its first ``T`` of 30 frames as the film-strip
``[64, T, 64, 3]`` float32 in [0, 1] (``astype(float32) / 255``, then the
transpose, in numpy, as JAX's does).
"""

from __future__ import annotations

import os
from typing import Iterator

import numpy as np

from .io import iter_tfrecord, parse_sequence_example

__all__ = ["robot_push_samples"]

_FRAMES_PER_VIDEO = 30
_IMG_SHAPE = (64, 64, 3)


def robot_push_samples(
    data_dir: str,
    time_steps: int = 30,
    train: bool = True,
    *,
    image_key: str = "image_aux1",
) -> Iterator[np.ndarray]:
    """Yield film-strip videos ``[64, T, 64, 3]`` from BAIR tfrecords.

    ``data_dir`` is the ``softmotion30_44k`` root containing
    ``train/``/``test/`` subdirs of tfrecord shards.
    """
    subdir = "train" if train else "test"
    filedir = os.path.join(data_dir, subdir)
    files = sorted(
        f for f in os.listdir(filedir) if os.path.isfile(os.path.join(filedir, f))
    )
    if not files:
        raise FileNotFoundError(f"no BAIR tfrecord files in {filedir}")
    for filename in files:
        path = os.path.join(filedir, filename)
        for record in iter_tfrecord(path):
            context, _ = parse_sequence_example(record)
            frames = []
            ok = True
            for i in range(min(_FRAMES_PER_VIDEO, time_steps)):
                vals = context.get(f"{i}/{image_key}/encoded")
                if not vals:
                    ok = False
                    break
                img = np.frombuffer(vals[0], dtype=np.uint8)
                if img.size != np.prod(_IMG_SHAPE):
                    ok = False
                    break
                frames.append(img.reshape(_IMG_SHAPE))
            if not ok or not frames:
                continue
            video = np.stack(frames).astype(np.float32) / 255.0  # [T, 64, 64, 3]
            strip = np.transpose(video, (1, 0, 2, 3))  # [64, T, 64, 3]
            yield strip
