"""Carry state from the JAX package into this one, as numpy arrays.

Nothing here imports the JAX package: its state reaches this module as
numpy arrays (``DNDarray.numpy()`` there, a fitted estimator's attributes).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .cluster.kmeans import KMeans
from .core import factories
from .core.dndarray import DNDarray

__all__ = ["KMeans", "array_from_numpy"]


def array_from_numpy(global_np: np.ndarray, split: Optional[int] = None, dtype=None,
                     device=None, comm=None) -> DNDarray:
    """A DNDarray holding ``global_np`` (the whole global array, the same on
    every rank), distributed along ``split``; numpy's dtype is kept unless
    ``dtype`` is given."""
    return factories.array(np.asarray(global_np), dtype=dtype, split=split, device=device,
                           comm=comm)
