"""K-Medians clustering (counterpart of ``heat_tpu/cluster/kmedians.py``):
the Lloyd loop with Manhattan assignment and a per-cluster, per-dimension
median update.

The loop runs on the host and reads the shift once an iteration, as the
port's KMeans does (the JAX package runs it on the device). The medians
come from one sort of each column by (label, value): a stable sort by
value, then a stable sort by label, and numpy's midpoint of the two middle
members, with no masked copy per cluster. Across ranks the data is resplit
to columns once a fit, each rank computes the medians of its columns over
every row (the labels gathered each iteration), and the ``(k, d)`` medians
are gathered. An empty cluster keeps its center.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from ..core import types
from ..core.dndarray import DNDarray
from ._kcluster import _KCluster, _argmin_rows, _d1, _rows

__all__ = ["KMedians"]


def _column_medians(xc: torch.Tensor, labels: torch.Tensor, k: int):
    """``(medians (k, dc), has (k,))``: each cluster's median of each column
    of ``xc`` (all rows, ``labels`` their clusters); a cluster without
    members has ``has`` False and an unspecified median."""
    n = xc.shape[0]
    counts = torch.bincount(labels, minlength=k)
    starts = torch.cumsum(counts, 0) - counts
    by_value = torch.argsort(xc, dim=0, stable=True)
    by_label = torch.argsort(labels[by_value], dim=0, stable=True)
    ordered = xc.gather(0, by_value.gather(0, by_label))  # each column by (label, value)
    last = max(n - 1, 0)
    lo = (starts + torch.clamp(counts - 1, min=0) // 2).clamp(max=last)
    hi = (starts + counts // 2).clamp(max=last)
    if n == 0:
        return xc.new_zeros((k, xc.shape[1])), counts > 0
    return (ordered[lo] + ordered[hi]) * 0.5, counts > 0


def _median_fit(est: _KCluster, x: DNDarray, snap: bool):
    """The KMedians loop (``snap=False``) or KMedoids' (each median then
    snapped to the data point nearest to it in L1 over the whole data set,
    the lowest index on ties). Sets the estimator's fitted attributes."""
    if not isinstance(x, DNDarray):
        raise TypeError(f"input needs to be a DNDarray, but was {type(x)}")
    if x.ndim != 2:
        raise ValueError("input needs to be 2D")
    if x.split not in (None, 0):
        x = x.resplit(0)
    dt = types.promote_types(x.dtype, types.float32)
    tdt = dt.torch_type()
    xb = x.larray.to(tdt)
    centers = est._initialize_cluster_centers(x).to(tdt)
    k, d = centers.shape
    comm = x.comm if x.split == 0 and x.comm.size > 1 else None
    if comm is None:
        xc, cols = xb, slice(0, d)
    else:
        xc = x.resplit(1).larray.to(tdt)  # every row of this rank's columns
        cols = comm.chunk((x.shape[0], d), 1)[2][1]
    shift, it = float("inf"), 0
    while it < est.max_iter and shift > est.tol:
        labels = torch.argmin(_d1(xb, centers), dim=1)
        every = labels if comm is None else comm.allgather(labels, 0, x.shape[0])
        med, has = _column_medians(xc, every, k)
        if comm is not None:
            med = comm.allgather(med, 1, d)
        if snap:
            med = _rows(x, xb, _argmin_rows(x, _d1(xb, med)))
        new = torch.where(has[:, None], med, centers)
        shift = float(((new - centers) ** 2).sum())
        centers, it = new, it + 1
    dist = _d1(xb, centers)
    labels = torch.argmin(dist, dim=1).to(torch.int64)
    inertia = dist.min(dim=1).values.sum() if dist.shape[0] else xb.new_zeros(())
    if comm is not None:
        inertia = comm.allreduce(inertia.reshape(1)).reshape(())
    est._cluster_centers = DNDarray(centers, (k, d), dt, None, x.device, x.comm, True)
    est._labels = DNDarray(labels, (x.shape[0],), types.int64, x.split, x.device, x.comm, True)
    est._inertia = float(inertia)
    est._n_iter = it
    return est


class KMedians(_KCluster):
    """K-Medians clusterer (reference kmedians.py:10): Manhattan assignment,
    median update, until the squared shift of the centers is at most
    ``tol`` or ``max_iter`` iterations."""

    def __init__(
        self,
        n_clusters: int = 8,
        init: Union[str, DNDarray] = "random",
        max_iter: int = 300,
        tol: float = 1e-4,
        random_state: Optional[int] = None,
    ):
        super().__init__("manhattan", n_clusters, init, max_iter, tol, random_state)

    def fit(self, x: DNDarray) -> "KMedians":
        """Median-update Lloyd iterations (reference kmedians.py `fit`)."""
        return _median_fit(self, x, snap=False)
