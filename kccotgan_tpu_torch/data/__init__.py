"""Host-side data: fixtures, the MMNIST loader, the batch pipeline and
the copy of each batch to the card."""

from .datasets import make_dataset
from .mmnist import load_mmnist, mmnist_paths
from .pipeline import ArrayDataset, GeneratorDataset, device_prefetch
from .synthetic import bouncing_blobs, write_mmnist_fixture

__all__ = [
    "make_dataset",
    "load_mmnist",
    "mmnist_paths",
    "ArrayDataset",
    "GeneratorDataset",
    "device_prefetch",
    "bouncing_blobs",
    "write_mmnist_fixture",
]
