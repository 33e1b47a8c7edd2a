"""Endpoint adapters: fitted estimators as batched inference programs.

Counterpart of ``heat_tpu/serve/endpoints.py``. An :class:`Endpoint` is
what the server dispatches: a function ``fn(batch, *params)`` over a
``(bucket, features)`` request batch and the fitted parameters, built once
per ladder bucket through :func:`heat_tpu_torch.core.program_cache.cached_program`
(site ``serve.<name>``): on the card a CUDA graph per bucket, captured at
the warm-up and replayed for every later batch of that bucket.

Two families of forms, chosen by ``HEAT_TPU_SERVE_EXACT`` (default on):

* **exact**: every reduction over a row is a halving tree of elementwise
  adds over the reduced axis, zero-padded to a power of two. Its order of
  addition is fixed by the feature count alone, never by the batch, so a
  request served inside a padded 64-row bucket returns the same bits as
  the same request dispatched alone, on the card as on the CPU (torch's
  own reductions choose their split of a row from the output count, and
  on the card a wide row may be split in one bucket and not in another).
  Ties go to the lower index (``argmin``/``argmax``, a stable sort for the
  KNN neighbours), as ``lax.top_k`` and ``jnp.argmin`` do.
  The broadcast forms are computed over tiles of the reference rows (the
  centres, the training set, the weight's columns), so that their
  ``(bucket, tile, features)`` intermediates stay near 32 MiB however
  many rows the reference has; each element keeps its own order of
  addition, so the tiling changes no bit.
* **fast** (``HEAT_TPU_SERVE_EXACT=0``): the GEMM forms the estimators use
  (``x² + c² − 2xcᵀ``); batched against solo only to f32 rounding. The
  server captures every serving program with TF32 off (the JAX package's
  ``Precision.HIGH``), the caller's flag restored.

``sparse_query``'s rows arrive as a padded CSR batch; each row's products
are summed by a pairwise tree over the row's own elements in their order
(never ``index_add_``, whose atomics on the card add in no fixed order),
so its answers too are independent of the batch.

Parameters are arguments of the program, as in the JAX package: a restored
or republished endpoint with the same shapes re-enters the same registry
entries (no capture). On the card the programs of one endpoint's buckets
share one set of static parameter buffers, copied into once a version.
``gaussian_nb_predict`` computes in float64, on the card too.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import _knobs as knobs
from ..core import devices

__all__ = [
    "Endpoint",
    "cdist_query",
    "dense_forward",
    "exact_mode",
    "gaussian_nb_predict",
    "kmeans_predict",
    "knn_classify",
    "lasso_predict",
    "rbf_query",
    "rebuild",
    "sparse_query",
]


def exact_mode() -> bool:
    """Whether the batch-stable forms are active (``HEAT_TPU_SERVE_EXACT``,
    default on)."""
    return bool(knobs.get("HEAT_TPU_SERVE_EXACT"))


# -- forms whose order of addition is fixed by the reduced axis alone -------------


def _tree_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis by a halving tree of elementwise adds, the
    axis zero-padded to a power of two."""
    n = t.shape[-1]
    width = 1 << max(0, (n - 1).bit_length()) if n > 1 else 1
    if width != n:
        t = F.pad(t, (0, width - n))
    while t.shape[-1] > 1:
        half = t.shape[-1] // 2
        t = t[..., :half] + t[..., half:]
    return t[..., 0]


# the bytes of one tile's (rows, tile, features) intermediate
_TILE_BYTES = 32 << 20


def _by_tiles(rows: int, ref: torch.Tensor, fn: Callable) -> torch.Tensor:
    """``fn(ref_tile) -> (rows, tile)`` over tiles of ``ref``'s rows, in
    order, gathered into the ``(rows, len(ref))`` result."""
    n, width = ref.shape[0], ref.shape[1] if ref.ndim > 1 else 1
    step = max(1, _TILE_BYTES // max(1, rows * width * ref.element_size()))
    if step >= n:
        return fn(ref)
    out = None
    for lo in range(0, n, step):
        part = fn(ref[lo:lo + step])
        if out is None:
            out = torch.empty((part.shape[0], n), dtype=part.dtype, device=part.device)
        out[:, lo:lo + part.shape[1]] = part
    return out


def _d2_exact(xb, c):
    def tile(ct):
        diff = xb[:, None, :] - ct[None, :, :]
        return _tree_sum(diff * diff)

    return _by_tiles(xb.shape[0], c, tile)


def _d2_fast(xb, c):
    x2 = torch.sum(xb * xb, dim=1, keepdim=True)
    c2 = torch.sum(c * c, dim=1)[None, :]
    return torch.clamp(x2 + c2 - 2.0 * (xb @ c.T), min=0.0)


def _d2(xb, c, exact: bool):
    return _d2_exact(xb, c) if exact else _d2_fast(xb, c)


def _matmul(a, b, exact: bool):
    if exact:
        return _by_tiles(a.shape[0], b.T, lambda bt: _tree_sum(a[:, None, :] * bt[None, :, :]))
    return a @ b


def _activate(y, act):
    if act == "relu":
        return torch.clamp(y, min=0.0)
    if act == "tanh":
        return torch.tanh(y)
    if act == "sigmoid":
        return 1.0 / (1.0 + torch.exp(-y))
    return y


# -- the kinds' functions ---------------------------------------------------------


def _kmeans_fn(xb, params, cfg):
    (centers,) = params
    d2 = _d2(xb.to(centers.dtype), centers, cfg["exact"])
    return torch.argmin(d2, dim=1).to(torch.int64)


def _knn_fn(xb, params, cfg):
    xt, yt, classes = params
    d2 = _d2(xb.to(xt.dtype), xt, cfg["exact"])
    idx = torch.sort(d2, dim=1, stable=True).indices[:, :cfg["k"]]
    neigh = yt[idx]
    votes = torch.sum((neigh[:, :, None] == classes[None, None, :]).to(torch.int32), dim=1)
    return classes[torch.argmax(votes, dim=1)]


def _gnb_fn(xb, params, cfg):
    theta, var, prior, classes = params
    theta, var = theta.to(torch.float64), var.to(torch.float64)
    xl = xb.to(torch.float64)
    log_prior = torch.log(prior.to(torch.float64))[None, :]
    n_ij = -0.5 * _tree_sum(torch.log(2.0 * math.pi * var))[None, :]
    diff = xl[:, None, :] - theta[None, :, :]
    quad = -0.5 * _tree_sum(diff * diff / var[None, :, :])
    return classes[torch.argmax(log_prior + n_ij + quad, dim=1)]


def _lasso_fn(xb, params, cfg):
    coef, intercept = params
    xc = xb.to(coef.dtype)
    if cfg["exact"]:
        return _tree_sum(xc * coef[None, :]) + intercept
    return xc @ coef + intercept


def _cdist_fn(xb, params, cfg):
    (y,) = params
    d2 = torch.clamp(_d2(xb.to(y.dtype), y, cfg["exact"]), min=0.0)
    gamma = cfg.get("gamma")
    if gamma is not None:
        return torch.exp(-gamma * d2)
    return torch.sqrt(d2)


def _dense_fn(xb, params, cfg):
    w = params[0]
    y = _matmul(xb.to(w.dtype), w, cfg["exact"])
    if cfg["bias"]:
        y = y + params[1]
    return _activate(y, cfg.get("activation"))


def _sparse_query_fn(xb, params, cfg):
    """``activation(x_sparse @ w + bias)`` over a padded CSR batch
    ``(indptr, indices, values)``: pad element slots lie past
    ``indptr[-1]`` and belong to no row, pad rows are empty (bias only).
    Each element's product ``values[i] * w[indices[i]]`` is summed into its
    row's first element by a pairwise tree over the row's own elements
    (level ``h`` adds element ``i + h`` into element ``i`` when ``i`` sits at
    an offset from the row's start divisible by ``2h`` and ``i + h`` is still
    in the row), so the order depends on the row alone."""
    indptr, indices, values = xb
    w = params[0]
    rows_n = indptr.shape[0] - 1
    nnz_cap = indices.shape[0]
    pos = torch.arange(nnz_cap, device=indices.device, dtype=indptr.dtype)
    row = torch.searchsorted(indptr, pos, right=True) - 1  # pad slots: row rows_n
    start = indptr[row]
    end = indptr[torch.clamp(row + 1, max=rows_n)]  # pad slots: end <= pos
    offset = pos - start
    contrib = values[:, None] * w[indices.long()]
    h = 1
    while h < nnz_cap:
        take = ((offset % (2 * h)) == 0) & (pos + h < end)
        shifted = torch.cat([contrib[h:], torch.zeros_like(contrib[:h])])
        contrib = torch.where(take[:, None], contrib + shifted, contrib)
        h *= 2
    first = indptr[:-1]
    nonempty = indptr[1:] > first
    y = torch.where(nonempty[:, None], contrib[torch.clamp(first, max=nnz_cap - 1).long()],
                    torch.zeros((), dtype=contrib.dtype, device=contrib.device))
    if cfg["bias"]:
        y = y + params[1]
    return _activate(y, cfg.get("activation"))


_KIND_FNS: Dict[str, Callable] = {
    "kmeans_predict": _kmeans_fn,
    "knn_classify": _knn_fn,
    "gaussian_nb_predict": _gnb_fn,
    "lasso_predict": _lasso_fn,
    "cdist_query": _cdist_fn,
    "dense_forward": _dense_fn,
    "sparse_query": _sparse_query_fn,
}

# kinds whose requests are ragged CSR row batches (sparse.host.CsrRows)
_SPARSE_KINDS = frozenset({"sparse_query"})


def _np_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty(0, dtype=dtype).numpy().dtype


def _tensor(p, device: torch.device) -> torch.Tensor:
    """A parameter as this endpoint's own tensor on ``device``."""
    if isinstance(p, torch.Tensor):
        return p.detach().to(device).clone()
    return torch.from_numpy(np.array(p)).to(device)


class Endpoint:
    """One named family of inference programs: ``kind`` selects the form,
    ``params`` are the fitted tensors (program arguments, on ``device``:
    the card unless the CPU is asked for), ``config`` the static knobs (part
    of the registry key). ``features`` and ``dtype`` are the request
    contract the server validates."""

    __slots__ = ("kind", "params", "config", "features", "dtype", "version", "device", "_key")

    def __init__(self, kind: str, params: Sequence, config: Optional[Dict[str, Any]] = None, *,
                 features: int, dtype, version: int = 1, device=None):
        if kind not in _KIND_FNS:
            raise ValueError(f"unknown endpoint kind {kind!r}; known: {sorted(_KIND_FNS)}")
        self.kind = kind
        self.device = devices.sanitize_device(device).torch_device
        self.params = tuple(_tensor(p, self.device) for p in params)
        self.config = dict(config or {})
        self.config.setdefault("exact", exact_mode())
        self.features = int(features)
        self.dtype = np.dtype(dtype)
        # the version does not ride in the program key: a same-shape
        # republish re-enters the warm programs
        if int(version) < 1:
            raise ValueError(f"endpoint version must be >= 1, got {version}")
        self.version = int(version)
        # made once: the server asks for the keys at every batch
        self._key = (self.kind, self.cfg_key(), self.features, str(self.dtype),
                     self._param_sig(), str(self.device))

    @property
    def is_sparse(self) -> bool:
        """Whether requests are CSR row batches instead of dense rows."""
        return self.kind in _SPARSE_KINDS

    def cfg_key(self) -> Tuple:
        return tuple(sorted(self.config.items()))

    def _param_sig(self) -> Tuple:
        return tuple((tuple(p.shape), str(p.dtype)) for p in self.params)

    def program_key(self, bucket: int, nnz_cap: Optional[int] = None) -> Tuple:
        """The registry key of one ladder bucket (and nnz bucket for sparse
        kinds): the parameters' shapes and types and the device ride in it,
        their values do not."""
        if nnz_cap is None:
            return self._key + (int(bucket),)
        return self._key + (int(bucket), int(nnz_cap))

    def params_key(self) -> Tuple:
        """The key of the endpoint's parameter set, shared by the programs
        of all its buckets: :meth:`program_key` without the buckets."""
        return self._key

    @property
    def n_inputs(self) -> int:
        """The program's request arguments before its parameters: the
        padded CSR batch's three arrays, or the dense rows."""
        return 3 if self.is_sparse else 1

    def build(self) -> Callable:
        """The program's callable (runs on a registry miss only)."""
        fn = _KIND_FNS[self.kind]
        cfg = dict(self.config)

        if self.is_sparse:
            def call(indptr, indices, values, *params):
                return fn((indptr, indices, values), params, cfg)

            return call

        def call(xb, *params):
            return fn(xb, params, cfg)

        return call

    def nnz_cap_for(self, bucket: int, nnz: int) -> int:
        """The nnz bucket of a coalesced sparse batch: the per-row capacity
        rounded up to a power of two, capped at ``features`` for
        duplicate-free rows, times the row bucket (the JAX package's rule)."""
        per_row = max(1, -(-int(nnz) // max(1, int(bucket))))
        cap = 1
        while cap < per_row:
            cap *= 2
        if per_row <= max(1, self.features):
            cap = min(cap, max(1, self.features))
        return int(bucket) * cap

    def nnz_ladder(self, bucket: int) -> Tuple[int, ...]:
        """Every nnz bucket :meth:`nnz_cap_for` can give for one row bucket
        (duplicate-free rows): the warm-up lattice."""
        caps = []
        c = 1
        while True:
            caps.append(int(bucket) * min(c, max(1, self.features)))
            if c >= self.features:
                break
            c *= 2
        return tuple(dict.fromkeys(caps))

    def cost_bytes(self, bucket: int) -> int:
        """Analytic bytes of one ``bucket``-row dispatch: the request, the
        (bucket, n_ref) intermediate and the output (sparse kinds price
        dense rows). The admission controller's estimate until a warm build
        measured the bucket."""
        item = max(self.dtype.itemsize, 4)
        if self.is_sparse:
            k = self.params[0].shape[1] if self.params[0].ndim > 1 else 1
            nnz = bucket * self.features
            inp = (bucket + 1) * 4 + nnz * (4 + item)
            mid = nnz * max(k, 1) * item
            out = bucket * max(k, 1) * item
            return int(inp + mid + out)
        n_ref = self.params[0].shape[0] if self.params[0].ndim else 1
        inp = bucket * self.features * item
        mid = bucket * max(n_ref, 1) * item
        out = bucket * max(n_ref, 1) * item
        return int(inp + mid + out)

    def with_params(self, params: Sequence, *, version: Optional[int] = None) -> "Endpoint":
        """The same family with new parameters of the same shapes and types
        and the next version (or ``version``): the zero-capture publish."""
        ep = Endpoint(self.kind, params, config=dict(self.config), features=self.features,
                      dtype=self.dtype, device=self.device,
                      version=self.version + 1 if version is None else int(version))
        if ep._param_sig() != self._param_sig():
            raise ValueError("with_params needs the same parameter shapes and types (a swap "
                             f"without a capture): {self._param_sig()} -> {ep._param_sig()}")
        return ep

    def describe(self) -> dict:
        """The manifest record (checkpoint and restore)."""
        return {"kind": self.kind, "config": dict(self.config), "features": self.features,
                "dtype": str(self.dtype), "n_params": len(self.params),
                "version": self.version}


def rebuild(record: dict, params: Sequence, device=None) -> Endpoint:
    """An endpoint from its :meth:`Endpoint.describe` record and saved
    parameters (a record without a version restores at version 1)."""
    return Endpoint(record["kind"], params, config=record.get("config"),
                    features=record["features"], dtype=np.dtype(record["dtype"]),
                    version=int(record.get("version", 1)), device=device)


# -- estimator adapters -----------------------------------------------------------


def _replicated(x) -> torch.Tensor:
    """A fitted parameter as one whole tensor: a DNDarray's global value,
    a tensor as is, anything else through numpy."""
    from ..core.dndarray import DNDarray

    if isinstance(x, DNDarray):
        return x._global()
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x))


def _float(t: torch.Tensor) -> torch.Tensor:
    return t if t.is_floating_point() else t.to(torch.float32)


def kmeans_predict(est, device=None) -> Endpoint:
    """Serve ``est.predict`` of a fitted K-family clusterer: the nearest
    centre's label (int64)."""
    if est.cluster_centers_ is None:
        raise ValueError("estimator is not fitted (no cluster_centers_)")
    centers = _replicated(est.cluster_centers_)
    return Endpoint("kmeans_predict", [centers], features=int(centers.shape[1]),
                    dtype=_np_dtype(centers.dtype), device=device)


def knn_classify(est, device=None) -> Endpoint:
    """Serve a fitted ``KNeighborsClassifier``: distances, the k nearest
    (ties to the lower index), a one-hot vote."""
    if est.x is None:
        raise ValueError("estimator is not fitted (call fit first)")
    xt = _replicated(est.x).to(torch.float32)
    yt = _replicated(est.y).reshape(-1)
    classes = _replicated(est._classes)
    k = min(int(est.n_neighbors), int(xt.shape[0]))
    return Endpoint("knn_classify", [xt, yt, classes], {"k": k}, features=int(xt.shape[1]),
                    dtype=np.float32, device=device)


def gaussian_nb_predict(est, device=None) -> Endpoint:
    """Serve a fitted ``GaussianNB``: the class of largest joint
    log-likelihood, in float64."""
    if est.theta_ is None:
        raise ValueError("estimator is not fitted (call fit first)")
    theta = _replicated(est.theta_)
    params = [theta, _replicated(est.var_), _replicated(est.class_prior_),
              _replicated(est.classes_)]
    return Endpoint("gaussian_nb_predict", params, features=int(theta.shape[1]),
                    dtype=np.float64, device=device)


def lasso_predict(est, device=None) -> Endpoint:
    """Serve a fitted ``Lasso``: ``x @ coef + intercept``."""
    if est.theta is None:
        raise ValueError("estimator is not fitted (call fit first)")
    theta = _replicated(est.theta).reshape(-1)
    coef, intercept = theta[1:], theta[0]
    return Endpoint("lasso_predict", [coef, intercept], features=int(coef.shape[0]),
                    dtype=_np_dtype(coef.dtype), device=device)


def _reference(y) -> torch.Tensor:
    yb = _replicated(y)
    if yb.ndim != 2:
        raise ValueError(f"reference matrix must be 2-D, got {yb.ndim}-D")
    return _float(yb)


def cdist_query(y, device=None) -> Endpoint:
    """Serve euclidean distance rows against a fixed reference matrix
    ``y`` of shape (n_ref, d)."""
    yb = _reference(y)
    return Endpoint("cdist_query", [yb], features=int(yb.shape[1]),
                    dtype=_np_dtype(yb.dtype), device=device)


def rbf_query(y, sigma: float = 1.0, device=None) -> Endpoint:
    """Gaussian-kernel rows ``exp(−‖x−y‖²/2σ²)`` against a fixed reference
    matrix."""
    yb = _reference(y)
    gamma = 1.0 / (2.0 * float(sigma) * float(sigma))
    return Endpoint("cdist_query", [yb], {"gamma": gamma}, features=int(yb.shape[1]),
                    dtype=_np_dtype(yb.dtype), device=device)


def _affine_params(w, bias, activation, what: str):
    wb = _replicated(w)
    if wb.ndim != 2:
        raise ValueError(f"weight must be 2-D {what}, got {wb.ndim}-D")
    if activation not in (None, "relu", "tanh", "sigmoid"):
        raise ValueError(f"activation must be None/'relu'/'tanh'/'sigmoid', got {activation!r}")
    params = [wb]
    if bias is not None:
        bb = _replicated(bias).reshape(-1).to(wb.dtype)
        if bb.shape[0] != wb.shape[1]:
            raise ValueError(f"bias length {bb.shape[0]} != output width {wb.shape[1]}")
        params.append(bb)
    return wb, params


def sparse_query(w, bias=None, activation: Optional[str] = None, device=None) -> Endpoint:
    """Serve ``activation(x_sparse @ w + bias)`` over sparse feature rows:
    requests are ``sparse.host.CsrRows`` batches (or dense rows, compacted),
    padded by the batcher onto a (row bucket, nnz bucket) lattice. ``w`` is
    the dense (features, out) weight."""
    wb = _float(_replicated(w))
    wb, params = _affine_params(wb, bias, activation, "(features, out)")
    return Endpoint("sparse_query", params, {"bias": bias is not None, "activation": activation},
                    features=int(wb.shape[0]), dtype=_np_dtype(wb.dtype), device=device)


def dense_forward(w, bias=None, activation: Optional[str] = None, device=None) -> Endpoint:
    """Serve an affine layer ``activation(x @ w + bias)``, the
    ``nn.functional.dense`` forward."""
    wb, params = _affine_params(w, bias, activation, "(d_in, d_out)")
    return Endpoint("dense_forward", params, {"bias": bias is not None, "activation": activation},
                    features=int(wb.shape[0]), dtype=_np_dtype(wb.dtype), device=device)
