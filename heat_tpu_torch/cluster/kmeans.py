"""K-Means clustering (counterpart of ``heat_tpu/cluster/kmeans.py``).

The fit runs :func:`cuda_lloyd.lloyd_fit`: one accumulation pass per
iteration and one allreduce across ranks. Inside the Lloyd kernel's gate
(f32, d <= 512, k <= 1024, one rank or rows split) the pass is the kernel;
outside it, its plain torch version, as the JAX package takes its XLA
``_lloyd_step`` there. Labels and inertia come from one final plain
``_d2`` pass over the converged centers, as in the JAX package. A kernel
failure raises; nothing falls back. The checkpoint windows
(``kmeans.py:244-284`` there) are not ported yet.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from ..core import factories, types
from ..core.dndarray import DNDarray
from ._kcluster import _KCluster, _d2
from .cuda_lloyd import lloyd_fit, lloyd_update, lloyd_update_plain, pallas_lloyd_applicable

__all__ = ["KMeans"]


class KMeans(_KCluster):
    """K-Means clusterer (reference kmeans.py:13).

    Parameters
    ----------
    n_clusters : int
    init : 'random' | 'probability_based' | DNDarray
        ``'random'`` draws k distinct rows, ``'probability_based'`` seeds by
        k-means++; both draw from ``random_state`` as the JAX package does
        and pick its rows.
    max_iter : int
    tol : float
        Convergence threshold on the squared centroid shift.
    random_state : int, optional
    """

    def __init__(
        self,
        n_clusters: int = 8,
        init: Union[str, DNDarray] = "random",
        max_iter: int = 300,
        tol: float = 1e-4,
        random_state: Optional[int] = None,
    ):
        super().__init__("euclidean", n_clusters, init, max_iter, tol, random_state)

    @classmethod
    def from_state(cls, state: dict, device=None, comm=None) -> "KMeans":
        """A fitted estimator from numpy state: ``cluster_centers`` (k, d),
        ``n_iter`` and ``inertia`` (for instance the JAX package's fitted
        attributes), so that ``predict`` assigns as that estimator does."""
        centers = np.asarray(state["cluster_centers"])
        km = cls(n_clusters=int(centers.shape[0]))
        km._cluster_centers = factories.array(centers, split=None, device=device, comm=comm)
        km._n_iter = int(state["n_iter"])
        km._inertia = float(state["inertia"])
        return km

    def fit(self, x: DNDarray) -> "KMeans":
        """Run Lloyd iterations to convergence (reference kmeans.py:102)."""
        if not isinstance(x, DNDarray):
            raise TypeError(f"input needs to be a DNDarray, but was {type(x)}")
        if x.ndim != 2:
            raise ValueError("input needs to be 2D")
        dt = types.promote_types(x.dtype, types.float32)
        xb = x.larray.to(dt.torch_type())
        centers = self._initialize_cluster_centers(x).to(xb.dtype)
        # only a row-split array sums its ranks' passes; replicated data is whole on every rank
        comm = x.comm if x.split == 0 else None

        gated = pallas_lloyd_applicable(x.comm.size, x.split, x.shape[1], self.n_clusters, xb.dtype)
        update = lloyd_update if gated else lloyd_update_plain
        centers, n_iter = lloyd_fit(xb, centers, self.max_iter, self.tol, comm, update)

        d2 = _d2(xb, centers)
        labels = torch.argmin(d2, dim=1).to(torch.int64)
        inertia = d2.min(dim=1).values.sum() if d2.shape[0] else xb.new_zeros(())
        if comm is not None and comm.size > 1:
            inertia = comm.allreduce(inertia.reshape(1)).reshape(())

        self._cluster_centers = DNDarray(centers, tuple(centers.shape), dt, None, x.device, x.comm, True)
        self._labels = DNDarray(labels, (x.shape[0],), types.int64, x.split, x.device, x.comm, True)
        self._inertia = float(inertia)
        self._n_iter = int(n_iter)
        return self
