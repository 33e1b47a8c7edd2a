"""Datasets, loaders, out-of-core streaming and the matrix gallery
(counterpart of ``heat_tpu/utils/data``; reference heat/utils/data)."""

from . import matrixgallery
from .datatools import DataLoader, Dataset, dataset_ishuffle, dataset_shuffle
from .partial_dataset import (
    PartialDataLoaderIter,
    PartialDataset,
    PartialH5DataLoaderIter,
    PartialH5Dataset,
)

__all__ = [
    "DataLoader",
    "Dataset",
    "dataset_shuffle",
    "dataset_ishuffle",
    "PartialDataset",
    "PartialH5Dataset",
    "PartialDataLoaderIter",
    "PartialH5DataLoaderIter",
    "matrixgallery",
]


def __getattr__(name):
    # torchvision-gated: resolved when read, so the package imports without it
    if name == "MNISTDataset":
        from .mnist import MNISTDataset

        return MNISTDataset
    raise AttributeError(f"module heat_tpu_torch.utils.data has no attribute {name}")
