"""Micro-batched inference serving on the card.

Counterpart of ``heat_tpu/serve``:

* fitted estimators mount as named **endpoints** (:mod:`.endpoints`):
  KMeans ``predict``, KNN classify, cdist/rbf queries, Lasso and GaussianNB
  inference, the dense and sparse affine forwards;
* a thread-safe :class:`~.server.Server` accepts concurrent requests and a
  **micro-batcher** coalesces them into single dispatches through the
  program registry (:mod:`heat_tpu_torch.core.program_cache`): after
  :meth:`~.server.Server.warmup` has captured each bucket's CUDA graph, the
  steady state builds **nothing**, and in exact mode a batched answer is
  the same bits as the solo one;
* **admission control** (:mod:`.admission`) sheds 503-style before memory
  runs out, degrading the batch ladder under ``HEAT_TPU_HBM_BUDGET`` first;
* every dispatch runs under ``resilience.wrap_program``: a transient
  fault costs one batch retry; :meth:`~.server.Server.save` and
  :meth:`~.server.Server.restore` checkpoint the endpoints in the JAX
  package's format;
* :mod:`.net` puts HTTP replicas, a pool and a router in front of it.
"""

from __future__ import annotations

from .admission import AdmissionController, ServeError, ServerClosedError, ServerOverloadedError
from .endpoints import (
    Endpoint,
    cdist_query,
    dense_forward,
    gaussian_nb_predict,
    kmeans_predict,
    knn_classify,
    lasso_predict,
    rbf_query,
    sparse_query,
)
from .server import Server
from . import admission, endpoints, metrics, net, server, tracing  # noqa: F401

__all__ = [
    "AdmissionController",
    "Endpoint",
    "ServeError",
    "Server",
    "ServerClosedError",
    "ServerOverloadedError",
    "cdist_query",
    "dense_forward",
    "gaussian_nb_predict",
    "kmeans_predict",
    "knn_classify",
    "lasso_predict",
    "net",
    "rbf_query",
    "sparse_query",
]
