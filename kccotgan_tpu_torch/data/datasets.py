"""Dataset dispatch: name -> (train batch iterator, one test batch).

Counterpart of ``kccotgan_tpu/data/datasets.py`` for the datasets the
port reads so far, with the JAX package's sizes, seeds and test batch:
``synthetic`` (bouncing blobs) and ``mmnist`` (the ``.npy`` files).
Every loader yields film-strip batches ``[B, H, T, W, C]`` float32 in
[0, 1].  The TFRecord and video-file datasets raise until ROADMAP Queue
1 item 2 ports their readers.
"""

from __future__ import annotations

import os
from typing import Iterator

import numpy as np

from .mmnist import load_mmnist, mmnist_paths
from .pipeline import ArrayDataset
from .synthetic import bouncing_blobs

__all__ = ["make_dataset"]


def make_dataset(cfg) -> tuple[Iterator[np.ndarray], np.ndarray | None]:
    """Returns ``(train batches over cfg.n_epochs, one test batch or None)``."""
    m = cfg.model
    b, t = cfg.batch_size, cfg.total_time_steps

    if cfg.dname == "synthetic":
        data = bouncing_blobs(
            max(4 * b, 32), t, m.x_height, m.x_width, channels=m.n_channels, seed=cfg.seed,
        )
        ds = ArrayDataset(data, b, seed=cfg.seed)
        test = bouncing_blobs(b, t, m.x_height, m.x_width, channels=m.n_channels, seed=cfg.seed + 1)
        return ds.repeat(cfg.n_epochs), test

    if cfg.dname == "mmnist":
        train_path, test_path = mmnist_paths(cfg.data_path)
        ds = ArrayDataset(load_mmnist(train_path, t), b, seed=cfg.seed)
        test = load_mmnist(test_path, t)[:b] if os.path.exists(test_path) else None
        return ds.repeat(cfg.n_epochs), test

    raise NotImplementedError(
        f"dname={cfg.dname!r}: its reader is not ported (ROADMAP Queue 1 item 2, the TFRecord "
        "and video-file readers); the port reads 'synthetic' and 'mmnist'"
    )
