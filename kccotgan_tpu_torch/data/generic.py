"""Flat-feature TFRecord loader (the ``animation`` / ``human_action`` /
``ucf`` format).

Counterpart of ``kccotgan_tpu/data/generic.py``, the same code: records
are ``tf.train.Example``s with one packed float feature ``x`` of
``H*W*T*C`` values, parsed by ``parse_example_arrays`` into one numpy
buffer, the files reshuffled from a seeded ``random.Random`` before
each pass, forever.
"""

from __future__ import annotations

import glob
import random
from typing import Iterator

import numpy as np

from .io import iter_tfrecord, parse_example_arrays

__all__ = ["flat_feature_samples"]


def flat_feature_samples(
    pattern: str,
    height: int,
    width: int,
    time_steps: int,
    channels: int,
    *,
    feature_name: str = "x",
    shuffle_files: bool = True,
    seed: int = 1,
) -> Iterator[np.ndarray]:
    """Yield film-strip ``[H, T*W... ] -> [H, T, W, C]`` float32 videos
    from glob ``pattern`` of tfrecords with a flat float feature."""
    files = sorted(glob.glob(pattern))
    if not files:
        raise FileNotFoundError(f"no tfrecords match {pattern!r}")
    rng = random.Random(seed)
    expected = height * width * time_steps * channels
    while True:
        if shuffle_files:
            rng.shuffle(files)
        for path in files:
            for record in iter_tfrecord(path):
                # array-native parse: the packed float payload decodes
                # into ONE numpy buffer (native C++ or np.frombuffer)
                # instead of an 80k-element Python list — the host-side
                # cost that would otherwise starve the device step.
                feats = parse_example_arrays(record)
                x = feats.get(feature_name)
                if x is None or len(x) != expected:
                    continue
                arr = np.asarray(x, dtype=np.float32)
                yield arr.reshape(height, time_steps, width, channels)
