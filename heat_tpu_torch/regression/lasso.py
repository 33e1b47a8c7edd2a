"""L1-regularised linear regression by coordinate descent (counterpart of
``heat_tpu/regression/lasso.py``).

The mathematics is the JAX package's ``_cd_sweep`` (:25-80 there): an
intercept column first, the epoch-invariant curvature ``z = mean(x_j²)``,
and for each coordinate ``rho = mean(x_j·(y − ŷ + θ_j x_j))``, ``θ_0 =
rho/z_0`` for the intercept and ``soft(rho)/max(z_j, 1e-30)`` otherwise,
then ``ŷ += (θ_j' − θ_j) x_j``. Each epoch starts from ``ŷ = θ·Xᵀ``; the fit
stops when ``max|Δθ| ≤ tol`` or after ``max_iter`` epochs.

Each rank holds its chunk of rows (a feature-split ``x`` is resplit along
its rows once on entry, and ``y`` is cut to the same chunks). ``z`` is one
allreduce of the ``m + 1`` column sums and ``rho`` a local dot plus one
scalar allreduce. No value crosses to the host inside an epoch: θ, rho and
ŷ stay on the device, and the intercept branch is the static coordinate
index. The epoch is the registry program of site ``streaming.lasso``
(the JAX package's site, keyed as there on the shapes alone: the penalty
and the row count are 0-d tensor arguments): on one card a CUDA graph
captured once a shape and replayed (the counterpart of the JAX package's
single compiled ``while_loop``), with ``x`` and ``y`` as its parameters;
the convergence is read once an epoch. A world of several ranks runs the epoch inline,
since its graph would hold one collective a coordinate, and the CPU runs
the plain call.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from ..core import program_cache, types
from ..core.base import BaseEstimator, RegressionMixin
from ..core.dndarray import DNDarray

__all__ = ["Lasso"]


def _design(x: DNDarray, y: DNDarray, dtype: torch.dtype):
    """This rank's ``[1 | x]ᵀ`` (coordinates along rows) and ``y`` cut to
    the same rows, with the communicator that sums over rows (None when
    every rank holds all of them)."""
    if x.split is not None and x.split != 0:
        x = x.resplit(0)
    rows = x.larray.to(dtype)
    xt = torch.cat([torch.ones((rows.shape[0], 1), dtype=dtype, device=rows.device), rows],
                   dim=1).t().contiguous()
    comm = x.comm if x.split == 0 and x.comm.size > 1 else None
    if y.split == 0 and comm is not None:
        yb = y.larray
    else:
        yb = y._global()
        if comm is not None:
            counts, displs = comm.counts_displs(x.shape[0])
            yb = yb.narrow(0, displs[comm.rank], counts[comm.rank])
    yb = yb.reshape(yb.shape[0], -1)[:, 0].to(dtype).contiguous()
    return xt, yb, comm


def _epoch(theta: torch.Tensor, lam: torch.Tensor, n: torch.Tensor, xt: torch.Tensor,
           y: torch.Tensor, z: torch.Tensor, *, comm) -> Tuple[torch.Tensor, torch.Tensor]:
    """One coordinate-descent epoch from ``theta`` (the registry program of
    site ``streaming.lasso``): ``(θ', max|θ' − θ|)``. ``lam`` and ``n`` (the
    global row count) are 0-d tensors of ``xt``'s type, arguments as in the
    JAX package, so one program serves every penalty. It reads no knob, and
    no value crosses to the host."""
    th = theta.clone()
    y_est = torch.mv(xt.t(), th)
    for j in range(xt.shape[0]):
        xj, tj = xt[j], th[j]
        s = torch.dot(xj, (y - y_est) + tj * xj).reshape(1)
        if comm is not None:
            s = comm.allreduce(s)
        rho = s / n
        if j > 0:  # the intercept (j = 0) is not thresholded
            rho = torch.sign(rho) * torch.clamp(rho.abs() - lam, min=0.0)
        new = rho / z[j]
        y_est.addcmul_(xj, new - tj)
        th[j:j + 1].copy_(new)
    return th, torch.amax((th - theta).abs())


def _curvature(xt: torch.Tensor, n: int, comm) -> torch.Tensor:
    """The epoch-invariant curvature ``z = max(mean(x_j²), 1e-30)``."""
    z = (xt * xt).sum(dim=1)
    if comm is not None:
        z = comm.allreduce(z)
    return torch.clamp(z / n, min=1e-30)


def _epoch_program(xt: torch.Tensor, comm):
    """The registry program of one epoch, ``(θ, lam, n, xt, y, z) -> (θ',
    max|Δθ|)`` (site ``streaming.lasso``; it changes no input in place),
    keyed on the design's shape and type only, as the JAX package keys its
    site: every penalty and row count of one shape share the program and
    its one parameter set."""
    key = (tuple(xt.shape), str(xt.dtype))
    return program_cache.cached_program(
        "streaming.lasso", key, lambda: functools.partial(_epoch, comm=comm),
        comm=comm, params_from=3, params_key=key, inline=comm is not None)


def _cd_fit(xt: torch.Tensor, y: torch.Tensor, theta0: torch.Tensor, n: int, lam: float,
            tol: float, max_iter: int, comm):
    """Coordinate-descent epochs from ``theta0`` until ``max|Δθ| ≤ tol`` or
    ``max_iter`` epochs: ``(θ, epochs)``. The epoch is the registry program
    ``streaming.lasso``: on one card a CUDA graph captured at the first
    epoch of a shape (``x`` and ``y`` are its parameters, copied into the
    graph's buffers once a fit, not every epoch), inline with several ranks
    (its allreduces run on the caller's stream), the plain call on the
    CPU."""
    z = _curvature(xt, n, comm)
    epoch = _epoch_program(xt, comm)
    lam_t = torch.tensor(lam, dtype=xt.dtype, device=xt.device)
    n_t = torch.tensor(float(n), dtype=xt.dtype, device=xt.device)
    theta, it, diff = theta0, 0, float("inf")
    while it < max_iter and diff > tol:
        theta, d = epoch(theta, lam_t, n_t, xt, y, z)
        it += 1
        diff = float(d)
    return theta, it


class Lasso(BaseEstimator, RegressionMixin):
    """Lasso regressor (reference lasso.py:102).

    Parameters
    ----------
    lam : float
        L1 penalty weight.
    max_iter : int
        Maximum coordinate-descent epochs.
    tol : float
        Convergence threshold on the largest coefficient change.
    """

    def __init__(self, lam: float = 0.1, max_iter: int = 100, tol: float = 1e-6):
        self.lam = lam
        self.max_iter = max_iter
        self.tol = tol
        self.__theta = None
        self.n_iter = None

    @property
    def coef_(self) -> Optional[DNDarray]:
        return None if self.__theta is None else self.__theta[1:]

    @property
    def intercept_(self) -> Optional[DNDarray]:
        return None if self.__theta is None else self.__theta[0]

    @property
    def theta(self) -> Optional[DNDarray]:
        return self.__theta

    def soft_threshold(self, rho: DNDarray) -> DNDarray:
        """``sign(rho)·max(|rho| − lam, 0)``."""
        from ..core import arithmetics, rounding, statistics

        mag = arithmetics.sub(rounding.abs(rho), float(self.lam))
        return arithmetics.mul(rounding.sign(rho), statistics.maximum(mag, 0.0))

    def rmse(self, gt: DNDarray, yest: DNDarray) -> float:
        """Root mean squared error."""
        from ..core import arithmetics, exponential, statistics

        d = arithmetics.sub(gt, yest)
        return float(exponential.sqrt(statistics.mean(arithmetics.mul(d, d))).item())

    @staticmethod
    def _check(x, y) -> None:
        if not isinstance(x, DNDarray) or not isinstance(y, DNDarray):
            raise TypeError("x and y need to be DNDarrays")
        if x.ndim != 2:
            raise ValueError("x needs to be 2D")
        if y.ndim not in (1, 2):
            raise ValueError("y needs to be 1D or 2D")

    def _run(self, x: DNDarray, y: DNDarray, theta0: Optional[torch.Tensor]) -> "Lasso":
        dt = types.promote_types(x.dtype, types.float32)
        xt, yb, comm = _design(x, y, dt.torch_type())
        if theta0 is None:
            theta0 = torch.zeros(xt.shape[0], dtype=xt.dtype, device=xt.device)
        theta, n_iter = _cd_fit(xt, yb, theta0.to(xt.dtype), x.shape[0], float(self.lam),
                                float(self.tol), int(self.max_iter), comm)
        self.n_iter = n_iter
        self.__theta = DNDarray(theta, tuple(theta.shape), dt, None, x.device, x.comm, True)
        return self

    def fit(self, x: DNDarray, y: DNDarray) -> "Lasso":
        """Coordinate descent with an intercept column, from zero."""
        self._check(x, y)
        return self._run(x, y, None)

    def partial_fit(self, x: DNDarray, y: DNDarray) -> "Lasso":
        """Coordinate-descent epochs on one chunk of a stream, warm-started
        from the coefficients of the previous call (from zero on the
        first)."""
        self._check(x, y)
        prev = self.__theta
        if prev is not None and prev.shape[0] != x.shape[1] + 1:
            raise ValueError(
                f"partial_fit chunk has {x.shape[1]} features but the carried coefficients "
                f"expect {prev.shape[0] - 1}")
        return self._run(x, y, None if prev is None else prev.larray)

    def predict(self, x: DNDarray) -> DNDarray:
        """``x θ + intercept``."""
        if self.__theta is None:
            raise RuntimeError("fit needs to be called before predict")
        from ..core import arithmetics
        from ..core.linalg import matmul

        return arithmetics.add(matmul(x, self.__theta[1:]), self.__theta[0])
