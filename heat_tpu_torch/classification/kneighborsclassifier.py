"""k-nearest-neighbours classifier (counterpart of
``heat_tpu/classification/kneighborsclassifier.py``).

``fit`` replicates the training set on every rank. ``predict`` takes each
rank's query rows in blocks (so that the (rows, n) distances stay under
256 MiB): ``_d2`` against the training set, the ``k`` nearest by a stable
sort (the lower index first among equal distances, as ``jax.lax.top_k``
keeps them; ``torch.topk`` promises no order among ties), and a vote that
takes the lowest class on ties.
"""

from __future__ import annotations

import torch

from ..core.base import BaseEstimator, ClassificationMixin
from ..core.dndarray import DNDarray

__all__ = ["KNeighborsClassifier"]

_BLOCK_BUDGET = 1 << 28  # bytes of one block's (rows, n) float32 distances


class KNeighborsClassifier(BaseEstimator, ClassificationMixin):
    """KNN classifier (reference kneighborsclassifier.py:9).

    Parameters
    ----------
    n_neighbors : int
        Number of neighbours in the vote.
    """

    def __init__(self, n_neighbors: int = 5):
        self.n_neighbors = n_neighbors
        self.x = None
        self.y = None
        self._classes = None
        self._xt = None
        self._yt = None

    def fit(self, x: DNDarray, y: DNDarray) -> "KNeighborsClassifier":
        """Keep the training set, whole on every rank."""
        if not isinstance(x, DNDarray) or not isinstance(y, DNDarray):
            raise TypeError("x and y need to be DNDarrays")
        self.x, self.y = x, y
        self._xt = x._global().to(torch.float32)
        self._yt = y._global().reshape(-1)
        self._classes = torch.unique(self._yt)
        return self

    def predict(self, x: DNDarray) -> DNDarray:
        """The vote of the ``k`` nearest training samples of each sample
        (reference kneighborsclassifier.py:117)."""
        if self.x is None:
            raise RuntimeError("fit needs to be called before predict")
        from ..cluster._kcluster import _d2

        if x.split not in (None, 0):
            x = x.resplit(0)
        xq = x.larray.to(torch.float32)
        xt, yt = self._xt.to(xq.device), self._yt.to(xq.device)
        classes = self._classes.to(xq.device)
        n = xt.shape[0]
        k = min(self.n_neighbors, n)
        bs = max(1, _BLOCK_BUDGET // max(1, n * 4))
        pred = torch.empty(xq.shape[0], dtype=yt.dtype, device=xq.device)
        for s in range(0, xq.shape[0], bs):
            nearest = torch.sort(_d2(xq[s:s + bs], xt), dim=1, stable=True).indices[:, :k]
            votes = (yt[nearest][:, :, None] == classes[None, None, :]).sum(dim=1)
            pred[s:s + bs] = classes[torch.argmax(votes, dim=1)]
        return DNDarray(pred, (x.shape[0],), self.y.dtype, x.split, x.device, x.comm, True)
