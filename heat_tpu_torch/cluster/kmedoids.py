"""K-Medoids clustering (counterpart of ``heat_tpu/cluster/kmedoids.py``):
the KMedians loop with each median snapped to the data point nearest to
it in L1 over the whole data set (on every rank the same argmin, the lowest
global index on ties), iterated until the medoids stop moving (``tol`` 0)
or ``max_iter``; an empty cluster keeps its center."""

from __future__ import annotations

from typing import Optional, Union

from ..core.dndarray import DNDarray
from ._kcluster import _KCluster
from .kmedians import _median_fit

__all__ = ["KMedoids"]


class KMedoids(_KCluster):
    """K-Medoids clusterer (reference kmedoids.py:10); ``init='kmedoids++'``
    is ``'probability_based'``."""

    def __init__(
        self,
        n_clusters: int = 8,
        init: Union[str, DNDarray] = "random",
        max_iter: int = 300,
        random_state: Optional[int] = None,
    ):
        if init == "kmedoids++":
            init = "probability_based"
        super().__init__("manhattan", n_clusters, init, max_iter, 0.0, random_state)

    def fit(self, x: DNDarray) -> "KMedoids":
        """Medoid-update Lloyd iterations (reference kmedoids.py `fit`)."""
        return _median_fit(self, x, snap=True)
