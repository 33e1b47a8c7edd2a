"""K-Means clustering (counterpart of ``heat_tpu/cluster/kmeans.py``).

The fit runs :func:`cuda_lloyd.lloyd_fit`: one accumulation pass per
iteration and one allreduce across ranks. Inside the Lloyd kernel's gate
(f32, d <= 512, k <= 1024, one rank or rows split) the pass is the kernel;
outside it, its plain torch version, as the JAX package takes its XLA
``_lloyd_step`` there. Labels and inertia come from one final plain
``_d2`` pass over the converged centers, as in the JAX package. A kernel
failure raises; nothing falls back.

With ``checkpoint_every`` the fit runs as exact windows of
:func:`_lloyd_window` (``kmeans.py:129-141, 244-284`` there), saving the
centers, the iteration count and the shift carry through
``resilience.save_checkpoint`` after each; ``resume=True`` continues from
the checkpoint. The windows apply the same updates in the same order as
one uninterrupted fit, so both give the same centers bit for bit.

A fit is a ``kmeans.fit`` span (:func:`telemetry.span`) holding
``kmeans.init`` (the initial centers), the Lloyd loop's ``lloyd.*`` spans
and ``kmeans.label`` (the final ``_d2`` pass, the labels, the inertia and
its read, a ``telemetry.host_read`` at site ``kmeans.inertia``).
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from .. import telemetry
from ..core import factories, types
from ..core.dndarray import DNDarray
from ._kcluster import _KCluster, _d2
from .cuda_lloyd import (lloyd_fit, lloyd_update, lloyd_update_plain, lloyd_window,
                         pallas_lloyd_applicable)

__all__ = ["KMeans"]

# the resumable window of Lloyd iterations, the shift carry entering and
# leaving (the JAX package's ``_lloyd_window``, kmeans.py:47-65 there); the
# checkpointed fit and streaming.MiniBatchKMeans run it
_lloyd_window = lloyd_window


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
    checkpoint_every : int, optional
        Save the fit's state every this many Lloyd iterations
        (``resilience.save_checkpoint``); the fit then runs as exact
        windows, so that a killed run resumes at the last completed window
        and ends with the centers of an uninterrupted fit, bit for bit.
        Needs ``checkpoint_path``.
    checkpoint_path : str, optional
        The checkpoint directory (swapped atomically at every save).
    resume : bool
        Continue from ``checkpoint_path`` (when it holds a kmeans
        checkpoint) instead of the initial centers.
    """

    def __init__(
        self,
        n_clusters: int = 8,
        init: Union[str, DNDarray] = "random",
        max_iter: int = 300,
        tol: float = 1e-4,
        random_state: Optional[int] = None,
        checkpoint_every: Optional[int] = None,
        checkpoint_path: Optional[str] = None,
        resume: bool = False,
    ):
        super().__init__("euclidean", n_clusters, init, max_iter, tol, random_state)
        if checkpoint_every is not None:
            if checkpoint_every <= 0:
                raise ValueError(f"checkpoint_every must be positive, got {checkpoint_every}")
            if not checkpoint_path:
                raise ValueError("checkpoint_every requires checkpoint_path")
        elif resume:
            # resume runs only through the windows: ignoring it would redo
            # every completed iteration without a word
            raise ValueError("resume=True requires checkpoint_every")
        self.checkpoint_every = checkpoint_every
        self.checkpoint_path = checkpoint_path
        self.resume = resume

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
        with telemetry.span("kmeans.fit"):
            dt = types.promote_types(x.dtype, types.float32)
            xb = x.larray.to(dt.torch_type())
            with telemetry.span("kmeans.init"):
                centers = self._initialize_cluster_centers(x).to(xb.dtype)
            # only a row-split array sums its ranks' passes; replicated data is whole on every rank
            comm = x.comm if x.split == 0 else None

            gated = pallas_lloyd_applicable(x.comm.size, x.split, x.shape[1], self.n_clusters,
                                            xb.dtype)
            update = lloyd_update if gated else lloyd_update_plain
            if self.checkpoint_every is None:
                centers, n_iter = lloyd_fit(xb, centers, self.max_iter, self.tol, comm, update)
            else:
                centers, n_iter = self._fit_checkpointed(xb, centers, comm, update, x.comm)

            with telemetry.span("kmeans.label"):
                d2 = _d2(xb, centers)
                labels = torch.argmin(d2, dim=1).to(torch.int64)
                inertia = d2.min(dim=1).values.sum() if d2.shape[0] else xb.new_zeros(())
                if comm is not None and comm.size > 1:
                    inertia = comm.allreduce(inertia.reshape(1)).reshape(())
                self._inertia = telemetry.host_read(inertia, "kmeans.inertia")

            self._cluster_centers = DNDarray(centers, tuple(centers.shape), dt, None, x.device,
                                             x.comm, True)
            self._labels = DNDarray(labels, (x.shape[0],), types.int64, x.split, x.device,
                                    x.comm, True)
            self._n_iter = int(n_iter)
        return self

    def _fit_checkpointed(self, xb: torch.Tensor, centers: torch.Tensor, comm, update, world):
        """Lloyd iterations in windows of ``checkpoint_every``, saving
        (centers, iterations, shift) after each (``_fit_checkpointed``
        there). The shift travels through the manifest as a Python float,
        exact for an f32 value, so a resumed fit continues bit for bit."""
        from .. import resilience

        path, every = self.checkpoint_path, int(self.checkpoint_every)
        tol32 = float(torch.tensor(self.tol, dtype=xb.dtype))
        it_done, shift = 0, float("inf")
        if self.resume and resilience.checkpoint.exists(path):
            leaves, extra = resilience.load_checkpoint(path, with_extra=True)
            if extra.get("algo") != "kmeans" or len(leaves) != 1:
                raise resilience.CheckpointError(
                    f"{path!r} is a {extra.get('algo')!r} checkpoint, not kmeans")
            centers = leaves[0].to(device=xb.device, dtype=xb.dtype)
            it_done, shift = int(extra["n_iter"]), float(extra["shift"])
        while it_done < self.max_iter and shift > tol32:
            window = min(every, self.max_iter - it_done)
            centers, n_it, shift = _lloyd_window(xb, centers, shift, window, self.tol, comm,
                                                 update)
            it_done += n_it
            resilience.save_checkpoint(
                [centers], path, comm=world,
                extra={"algo": "kmeans", "n_iter": it_done, "shift": shift})
        return centers, it_done
