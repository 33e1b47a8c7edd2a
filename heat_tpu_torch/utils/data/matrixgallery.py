"""Synthetic test matrices (counterpart of
``heat_tpu/utils/data/matrixgallery.py``; reference
heat/utils/data/matrixgallery.py)."""

from __future__ import annotations

from typing import Optional, Type

from ...core import factories, types
from ...core.dndarray import DNDarray
from ...core.manipulations import resplit

__all__ = ["parter"]


def parter(
    n: int,
    split: Optional[int] = None,
    device=None,
    comm=None,
    dtype: Type[types.datatype] = None,
) -> DNDarray:
    """The Parter matrix ``A[i, j] = 1 / (j - i + 0.5)``, a Toeplitz matrix
    whose singular values cluster at pi (reference matrixgallery.py:15-61).

    ``split`` in {None, 0, 1} chooses the distributed axis of the result,
    which is built replicated by broadcasting ``arange`` and resplit (each
    rank slices its chunk), as in the JAX package.
    """
    dtype = dtype if dtype is not None else types.float32
    if split not in (None, 0, 1):
        raise ValueError(f"expected split in {{None, 0, 1}}, but was {split}")
    a = factories.arange(n, dtype=dtype, device=device, comm=comm)
    II = a.expand_dims(0)  # the row index varies along axis 1
    JJ = a.expand_dims(1)  # the column index varies along axis 0
    out = 1.0 / (II - JJ + 0.5)
    return out if split is None else resplit(out, split)
