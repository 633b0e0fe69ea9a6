"""Host-side data: fixtures, the MMNIST, GQN, BAIR, KTH, Penn Action and
flat-feature loaders, TFRecord / proto IO, the batch pipeline and the
copy of each batch to the card."""

from .datasets import make_dataset
from .mmnist import load_mmnist, mmnist_paths
from .pipeline import ArrayDataset, GeneratorDataset, device_prefetch
from .synthetic import bouncing_blobs, write_mmnist_fixture
from .tfrecord import (
    encode_example,
    encode_sequence_example,
    iter_tfrecord,
    parse_example,
    parse_example_arrays,
    parse_sequence_example,
    write_tfrecord,
)

__all__ = [
    "make_dataset",
    "load_mmnist",
    "mmnist_paths",
    "ArrayDataset",
    "GeneratorDataset",
    "device_prefetch",
    "bouncing_blobs",
    "write_mmnist_fixture",
    "iter_tfrecord",
    "parse_example",
    "parse_example_arrays",
    "parse_sequence_example",
    "encode_example",
    "encode_sequence_example",
    "write_tfrecord",
]
