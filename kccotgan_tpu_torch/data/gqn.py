"""GQN TFRecord datasets (Mazes and the others).

Counterpart of ``kccotgan_tpu/data/gqn.py``, the same code: the dataset
registry (sizes, frame size, sequence length), the file-template
listing, and the parse of each record's ``frames`` feature, a list of
JPEG strings decoded with PIL, resized (bilinear) to
``custom_frame_size``, cut to ``time_steps`` and laid out as the
film-strip ``[H, T, W, 3]``.

The stream is tf.data's ``list_files -> repeat -> shuffle(100) ->
interleave(cycle_length=4, block_length=16)``, built from
``pipeline.py``'s combinators, with the JPEG decode in an ordered
``parallel_map``; the shuffle's seed is drawn from ``random.Random(seed)``
as in JAX, so the port yields JAX's samples in JAX's order.
"""

from __future__ import annotations

import os
import random
from dataclasses import dataclass
from typing import Iterator

import numpy as np

from .io import iter_tfrecord, parse_example
from .pipeline import interleave, parallel_map, shuffle_stream

__all__ = ["GQN_DATASETS", "GqnDatasetInfo", "gqn_record_files", "GqnReader"]


@dataclass(frozen=True)
class GqnDatasetInfo:
    basepath: str
    train_size: int
    test_size: int
    frame_size: int
    sequence_size: int


# Registry mirrors `_DATASETS` (`data_utils.py:280-329`).
GQN_DATASETS: dict[str, GqnDatasetInfo] = {
    "jaco": GqnDatasetInfo("jaco", 3600, 400, 64, 11),
    "mazes": GqnDatasetInfo("mazes", 1080, 120, 84, 300),
    "rooms_free_camera_with_object_rotations": GqnDatasetInfo(
        "rooms_free_camera_with_object_rotations", 2034, 226, 128, 10
    ),
    "rooms_ring_camera": GqnDatasetInfo("rooms_ring_camera", 2160, 240, 64, 10),
    "rooms_free_camera_no_object_rotations": GqnDatasetInfo(
        "rooms_free_camera_no_object_rotations", 2160, 240, 64, 10
    ),
    "shepard_metzler_5_parts": GqnDatasetInfo(
        "shepard_metzler_5_parts", 900, 100, 64, 15
    ),
    "shepard_metzler_7_parts": GqnDatasetInfo(
        "shepard_metzler_7_parts", 900, 100, 64, 15
    ),
}


def gqn_record_files(info: GqnDatasetInfo, mode: str, root: str) -> list[str]:
    """``{root}/{base}/{mode}/{i:0Nd}-of-{num:0Nd}.tfrecord`` listing
    (`data_utils.py:335-347`)."""
    num = info.train_size if mode == "train" else info.test_size
    width = len(str(num))
    base = os.path.join(root, info.basepath, mode)
    return [
        os.path.join(base, f"{i + 1:0{width}d}-of-{num:0{width}d}.tfrecord")
        for i in range(num)
    ]


def _decode_jpeg(data: bytes) -> np.ndarray:
    from io import BytesIO

    from PIL import Image

    img = Image.open(BytesIO(data))
    return np.asarray(img.convert("RGB"), dtype=np.uint8)


class GqnReader:
    """Streaming sample iterator for a GQN dataset.

    Yields film-strip frames ``[H, T, W, 3]`` float32 in [0, 1].
    """

    def __init__(
        self,
        dataset: str,
        time_steps: int,
        root: str,
        mode: str = "train",
        custom_frame_size: int | None = None,
        shuffle_files: bool = True,
        seed: int = 1,
        shuffle_buffer: int = 100,
        cycle_length: int = 4,
        block_length: int = 16,
        decode_workers: int | None = None,
    ):
        if dataset not in GQN_DATASETS:
            raise ValueError(
                f"unknown GQN dataset {dataset!r}; available: {sorted(GQN_DATASETS)}"
            )
        info = GQN_DATASETS[dataset]
        if time_steps > info.sequence_size:
            raise ValueError(
                f"time_steps {time_steps} exceeds {dataset} sequence size "
                f"{info.sequence_size}"
            )
        self.info = info
        self.time_steps = time_steps
        self.custom_frame_size = custom_frame_size
        self.mode = mode
        self.root = root
        self.shuffle_files = shuffle_files
        self.shuffle_buffer = shuffle_buffer
        self.cycle_length = cycle_length
        self.block_length = block_length
        if decode_workers is None:
            # JAX's rule: a pool only helps when cores are free to run
            # it; on a 1-core host its dispatch costs more than it saves.
            ncpu = os.cpu_count() or 1
            decode_workers = 4 if ncpu >= 4 else (0 if ncpu == 1 else ncpu)
        self.decode_workers = decode_workers
        self._rng = random.Random(seed)

    def files(self) -> list[str]:
        files = [
            f
            for f in gqn_record_files(self.info, self.mode, self.root)
            if os.path.exists(f)
        ]
        if not files:
            raise FileNotFoundError(
                f"no GQN tfrecords under {self.root}/{self.info.basepath}/{self.mode}"
            )
        return files

    def _resize(self, frame: np.ndarray) -> np.ndarray:
        size = self.custom_frame_size
        if not size or size == frame.shape[0]:
            return frame
        from PIL import Image

        img = Image.fromarray(frame).resize((size, size), Image.BILINEAR)
        return np.asarray(img, dtype=np.uint8)

    def _file_stream(self) -> Iterator[str]:
        """Infinite file-name stream: list_files -> repeat -> shuffle(100)
        (`data_utils.py:417-419`)."""
        files = self.files()

        def repeated():
            while True:
                yield from files

        if not self.shuffle_files:
            yield from repeated()
            return
        yield from shuffle_stream(
            repeated(), self.shuffle_buffer, seed=self._rng.randrange(2**31)
        )

    def _decode_record(self, record: bytes) -> np.ndarray | None:
        feats = parse_example(record)
        jpegs = feats.get("frames", [])[: self.time_steps]
        if len(jpegs) < self.time_steps:
            return None
        frames = np.stack(
            [self._resize(_decode_jpeg(j)) for j in jpegs]
        )  # [T, H, W, 3]
        strip = np.transpose(frames, (1, 0, 2, 3))  # [H, T, W, 3]
        return strip.astype(np.float32) / 255.0

    def samples(self) -> Iterator[np.ndarray]:
        records = interleave(
            self._file_stream(),
            iter_tfrecord,
            cycle_length=self.cycle_length,
            block_length=self.block_length,
        )
        for strip in parallel_map(
            self._decode_record, records, workers=self.decode_workers
        ):
            if strip is not None:
                yield strip
