"""MNIST split across the ranks (counterpart of
``heat_tpu/utils/data/mnist.py``; reference heat/utils/data/mnist.py).

The reference subclasses ``torchvision.datasets.MNIST`` and keeps each
rank's slice. torchvision is optional: when present, :class:`MNISTDataset`
loads through it and wraps the images and labels as a split
:class:`~heat_tpu_torch.utils.data.Dataset`; without it the constructor
raises the JAX package's ``ImportError``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ...core import factories
from .datatools import Dataset

__all__ = ["MNISTDataset"]


class MNISTDataset(Dataset):
    """MNIST as a split Dataset.

    Parameters
    ----------
    root : str
        torchvision's download and cache directory.
    train : bool
        The training or the test split (a test split is never shuffled).
    split : int or None
        The distributed axis of the images and labels (0 or None).
    """

    def __init__(self, root: str, train: bool = True, transform=None, target_transform=None,
                 download: bool = True, split: Optional[int] = 0, ishuffle: bool = False,
                 test_set: bool = False, comm=None, device=None):
        try:
            from torchvision import datasets as tv_datasets
        except ImportError as e:
            raise ImportError("MNISTDataset requires torchvision, which is not installed") from e
        tv = tv_datasets.MNIST(root, train=train, transform=transform,
                               target_transform=target_transform, download=download)
        if transform is not None or target_transform is not None:
            # torchvision applies the transforms in __getitem__: read through
            # it, so that they take effect (tv.data is the raw array)
            samples = [tv[i] for i in range(len(tv))]
            images = np.stack([np.asarray(s[0]) for s in samples]).astype(np.float32)
            labels = np.asarray([s[1] for s in samples], dtype=np.int32)
        else:
            images = np.asarray(tv.data, dtype=np.float32)
            labels = np.asarray(tv.targets, dtype=np.int32)
        data = factories.array(images, split=split, comm=comm, device=device)
        targets = factories.array(labels, split=split, comm=comm, device=device)
        super().__init__(data, targets=targets, ishuffle=ishuffle,
                         test_set=test_set or not train)
