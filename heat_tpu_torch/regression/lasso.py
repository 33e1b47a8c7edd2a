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
index. On one card an epoch is captured once as a CUDA graph and replayed
(the counterpart of the JAX package's single compiled ``while_loop``); the
convergence is read once an epoch. A world of several ranks runs the epoch
eagerly, since its graph would hold one collective a coordinate, and so
does the CPU.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core import types
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


class _Sweep:
    """One coordinate-descent epoch in place on static buffers (θ, ŷ and
    the previous θ), so that it can be replayed from a CUDA graph."""

    def __init__(self, xt: torch.Tensor, y: torch.Tensor, theta: torch.Tensor, n: int,
                 lam: float, comm):
        self.xt, self.y, self.n, self.lam, self.comm = xt, y, n, lam, comm
        z = (xt * xt).sum(dim=1)
        if comm is not None:
            z = comm.allreduce(z)
        self.z = torch.clamp(z / n, min=1e-30)
        self.theta = theta
        self.prev = theta.clone()
        self.y_est = torch.empty_like(y)
        self.diff = torch.empty((), dtype=theta.dtype, device=theta.device)

    def __call__(self) -> None:
        xt, theta, y_est = self.xt, self.theta, self.y_est
        self.prev.copy_(theta)
        torch.mv(xt.t(), theta, out=y_est)
        for j in range(xt.shape[0]):
            xj, tj = xt[j], theta[j]
            s = torch.dot(xj, (self.y - y_est) + tj * xj).reshape(1)
            if self.comm is not None:
                s = self.comm.allreduce(s)
            rho = s / self.n
            if j > 0:  # the intercept (j = 0) is not thresholded
                rho = torch.sign(rho) * torch.clamp(rho.abs() - self.lam, min=0.0)
            new = rho / self.z[j]
            y_est.addcmul_(xj, new - tj)
            theta[j:j + 1].copy_(new)
        torch.amax((theta - self.prev).abs(), out=self.diff)


def _cd_fit(xt: torch.Tensor, y: torch.Tensor, theta0: torch.Tensor, n: int, lam: float,
            tol: float, max_iter: int, comm):
    """Coordinate-descent epochs from ``theta0`` until ``max|Δθ| ≤ tol`` or
    ``max_iter`` epochs: ``(θ, epochs)``. On one card the first epoch runs
    eagerly on a side stream (it also warms up the libraries) and the rest
    replay its CUDA graph."""
    sweep = _Sweep(xt, y, theta0.clone(), n, lam, comm)
    graphed = xt.is_cuda and comm is None
    it, diff = 0, float("inf")
    replay = None
    while it < max_iter and diff > tol:
        if replay is not None:
            replay.replay()
        elif graphed:
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                sweep()
            torch.cuda.current_stream().wait_stream(side)
            replay = torch.cuda.CUDAGraph()
            with torch.cuda.graph(replay):
                sweep()
        else:
            sweep()
        it += 1
        diff = float(sweep.diff)
    return sweep.theta, it


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
