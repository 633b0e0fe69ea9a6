"""Dataset dispatch: name -> (train batch iterator, one test batch).

Counterpart of ``kccotgan_tpu/data/datasets.py``, the same branches,
sizes, seeds and test batches (``tests/test_torch_readers.py`` holds
them to JAX's bit for bit): ``synthetic`` (bouncing blobs), ``mmnist``
(the ``.npy`` files), ``mazes`` and the other GQN sets (TFRecords of
JPEGs, test batch ``np_{name}_test.npy``), ``robot_push`` (BAIR
TFRecords), ``kth`` and ``penn_action`` (video files and JPEG folders,
their ``*_test/`` splits) and ``animation`` / ``human_action`` / ``ucf``
(flat-feature TFRecords).  Every loader yields film-strip batches
``[B, H, T, W, C]`` float32 in [0, 1], numpy on the host; they become
tensors in ``pipeline.device_prefetch``.  An unknown name raises
``ValueError``.
"""

from __future__ import annotations

import logging
import os
from typing import Iterator

import numpy as np

from ..config import TrainConfig
from .mmnist import load_mmnist, mmnist_paths
from .pipeline import ArrayDataset, GeneratorDataset
from .synthetic import bouncing_blobs

__all__ = ["make_dataset"]

_log = logging.getLogger(__name__)


def _drop_alpha(batch: np.ndarray, channels: int) -> np.ndarray:
    # `kernel_train.py:303`: keep the first `channels` channels.
    return batch[..., :channels]


def _collect_batch(
    it: Iterator[np.ndarray], n: int, *, what: str = "test split"
) -> np.ndarray | None:
    """Stack the first ``n`` samples of a generator, or None if it
    yields fewer.  A present-but-unusable split (e.g. every video in a
    populated kth_test/ shorter than time_steps) is distinguishable from
    'no test dir' by the warning."""
    samples = []
    for sample in it:
        samples.append(np.asarray(sample, dtype=np.float32))
        if len(samples) == n:
            return np.stack(samples)
    _log.warning(
        "%s yielded only %d of the %d samples needed for one batch; "
        "no test batch will be used (check video lengths vs time_steps)",
        what, len(samples), n,
    )
    return None


def make_dataset(cfg: TrainConfig) -> tuple[Iterator[np.ndarray], np.ndarray | None]:
    """Returns (train batch iterator over n_epochs, one test batch)."""
    m = cfg.model
    b, t = cfg.batch_size, cfg.total_time_steps

    if cfg.dname == "synthetic":
        data = bouncing_blobs(
            max(4 * b, 32), t, m.x_height, m.x_width, channels=m.n_channels,
            seed=cfg.seed,
        )
        ds = ArrayDataset(data, b, seed=cfg.seed)
        test = bouncing_blobs(b, t, m.x_height, m.x_width, channels=m.n_channels, seed=cfg.seed + 1)
        return ds.repeat(cfg.n_epochs), test

    if cfg.dname == "mmnist":
        train_path, test_path = mmnist_paths(cfg.data_path)
        train = load_mmnist(train_path, t)
        ds = ArrayDataset(train, b, seed=cfg.seed)
        test = None
        if os.path.exists(test_path):
            test = load_mmnist(test_path, t)[:b]
        return ds.repeat(cfg.n_epochs), test

    if cfg.dname == "mazes" or cfg.dname in _gqn_names():
        from .gqn import GqnReader

        name = cfg.dname
        reader = GqnReader(
            name, t, cfg.data_path, mode="train",
            custom_frame_size=m.x_height, seed=cfg.seed,
        )
        gen = GeneratorDataset(reader.samples, b, seed=cfg.seed)
        test_path = os.path.join(cfg.data_path, name, f"np_{name}_test.npy")
        test = None
        if os.path.exists(test_path):
            raw = np.load(test_path)[:b, :, :t]
            test = _drop_alpha(raw.astype(np.float32), m.n_channels)
        return gen.repeat(cfg.n_epochs), test

    if cfg.dname == "robot_push":
        from .bair import robot_push_samples

        root = os.path.join(cfg.data_path, "softmotion30_44k")
        train_gen = GeneratorDataset(
            lambda: robot_push_samples(root, t, train=True), b, seed=cfg.seed
        )
        test = None
        try:
            test_it = robot_push_samples(root, t, train=False)
            test = np.stack([next(test_it) for _ in range(b)])
        except (FileNotFoundError, StopIteration):
            pass
        return train_gen.repeat(cfg.n_epochs), test

    if cfg.dname == "kth":
        from .kth import kth_samples

        # Split dirs mirror the reference: kth/ for train, kth_test/
        # for the rollout-sampling test stream (`data_utils.py:163-166`,
        # `kernel_train.py:89-98`).
        root = os.path.join(cfg.data_path, "kth")
        test_root = os.path.join(cfg.data_path, "kth_test")
        gen = GeneratorDataset(
            lambda: kth_samples(root, b, m.x_height, m.x_width, t, seed=cfg.seed),
            b, seed=cfg.seed,
        )
        test = None
        if os.path.isdir(test_root):
            test_it = kth_samples(
                test_root, b, m.x_height, m.x_width, t, seed=cfg.seed + 1
            )
            test = _collect_batch(test_it, b, what=f"kth test dir {test_root}")
        return gen.repeat(cfg.n_epochs), test

    if cfg.dname == "penn_action":
        from .penn import penn_samples

        # The reference has no Penn test stream (`kernel_train.py:84-88`
        # sets only batched_x).  If a penn_frames_test/ split dir exists
        # (like kth_test/) the rollout-eval batch is truly held out;
        # otherwise it falls back to an IN-DISTRIBUTION batch drawn from
        # the training directory with a distinct seed — penn_samples
        # picks videos at random, so that batch may overlap the training
        # stream (documented limitation; provide penn_frames_test/ for a
        # real held-out split).
        root = os.path.join(cfg.data_path, "penn_frames")
        test_root = os.path.join(cfg.data_path, "penn_frames_test")
        gen = GeneratorDataset(
            lambda: penn_samples(root, b, m.x_height, m.x_width, t, seed=cfg.seed),
            b, seed=cfg.seed,
        )
        test = None
        if os.path.isdir(test_root):
            test_it = penn_samples(
                test_root, b, m.x_height, m.x_width, t, seed=cfg.seed + 1
            )
            test = _collect_batch(test_it, b, what=f"penn test dir {test_root}")
        elif os.path.isdir(root):
            test_it = penn_samples(
                root, b, m.x_height, m.x_width, t, seed=cfg.seed + 1
            )
            test = _collect_batch(test_it, b, what=f"penn train dir {root}")
        return gen.repeat(cfg.n_epochs), test

    if cfg.dname in ("animation", "human_action", "ucf"):
        from .generic import flat_feature_samples

        pattern = os.path.join(cfg.data_path, cfg.dname, "*.tfrecord")
        gen = GeneratorDataset(
            lambda: flat_feature_samples(
                pattern, m.x_height, m.x_width, t, m.n_channels, seed=cfg.seed
            ),
            b, seed=cfg.seed,
        )
        return gen.repeat(cfg.n_epochs), None

    raise ValueError(f"unknown dataset {cfg.dname!r}")


def _gqn_names():
    from .gqn import GQN_DATASETS

    return GQN_DATASETS.keys()
