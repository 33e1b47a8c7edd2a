"""Gaussian naive Bayes (counterpart of
``heat_tpu/naive_bayes/gaussianNB.py``).

The class moments are one-hot products over each rank's rows in float64
and one allreduce; ``partial_fit`` merges a batch's moments into the
stored ones (Chan et al.) with sorted ``classes_``; the joint log
likelihood runs over row blocks, so that the (rows, classes, features)
difference stays under 256 MiB.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..core import types
from ..core.base import BaseEstimator, ClassificationMixin
from ..core.dndarray import DNDarray
from ..core.factories import _from_global

__all__ = ["GaussianNB"]

_BLOCK_BUDGET = 1 << 28  # bytes of the (rows, classes, features) float64 difference


def _rows_like(v: torch.Tensor, x: DNDarray) -> torch.Tensor:
    """This rank's rows of the whole vector ``v``, aligned with ``x``'s."""
    if x.split == 0 and x.comm.size > 1:
        return v[x.comm.chunk(x.shape, 0)[2][0]]
    return v


def _reduced(x: DNDarray, *parts: torch.Tensor):
    """``parts`` summed over the ranks that hold ``x``'s rows."""
    if x.split != 0 or x.comm.size == 1:
        return parts
    flat = torch.cat([p.reshape(-1) for p in parts])
    x.comm.allreduce(flat)
    out, at = [], 0
    for p in parts:
        out.append(flat[at:at + p.numel()].reshape(p.shape))
        at += p.numel()
    return out


class GaussianNB(BaseEstimator, ClassificationMixin):
    """Gaussian naive Bayes (reference gaussianNB.py:12).

    Parameters
    ----------
    priors : DNDarray, optional
        Class priors; estimated from the data when None.
    var_smoothing : float
        Fraction of the largest feature variance added to all variances.
    """

    def __init__(self, priors: Optional[DNDarray] = None, var_smoothing: float = 1e-9):
        self.priors = priors
        self.var_smoothing = var_smoothing
        self.classes_ = None
        self.theta_ = None
        self.var_ = None
        self.class_prior_ = None
        self.class_count_ = None
        self.epsilon_ = None

    def __wrap(self, t: torch.Tensor, x: DNDarray) -> DNDarray:
        return _from_global(t, None, x.device, x.comm)

    def fit(self, x: DNDarray, y: DNDarray, sample_weight=None, _classes=None) -> "GaussianNB":
        """Per-class feature means and variances (reference gaussianNB.py
        `fit`); ``sample_weight`` scales each sample's share of the counts,
        means and variances."""
        if not isinstance(x, DNDarray) or not isinstance(y, DNDarray):
            raise TypeError("x and y need to be DNDarrays")
        if x.ndim != 2:
            raise ValueError(f"expected x to be a 2-D tensor, is {x.ndim}-D")
        if x.split not in (None, 0):
            x = x.resplit(0)
        xl = x.larray.to(torch.float64)
        dev = xl.device
        y_all = y._global().reshape(-1)
        yl = _rows_like(y_all, x)
        w = torch.ones(xl.shape[0], dtype=torch.float64, device=dev)
        if sample_weight is not None:
            sw = (sample_weight._global() if isinstance(sample_weight, DNDarray)
                  else torch.as_tensor(np.asarray(sample_weight), device=dev))
            sw = sw.to(device=dev, dtype=torch.float64).reshape(-1)
            if sw.shape[0] != x.shape[0]:
                raise ValueError("sample_weight length must match number of samples")
            w = w * _rows_like(sw, x)
        # sorted: partial_fit's moment merge relies on it
        classes = (torch.unique(y_all) if _classes is None
                   else torch.as_tensor(np.unique(np.asarray(_classes)), device=dev).to(y_all.dtype))
        k = classes.shape[0]
        onehot = (yl[:, None] == classes[None, :]).to(torch.float64) * w[:, None]
        valid = (w > 0).to(torch.float64)[:, None]
        counts, sums, sq, col_sum, n_valid = _reduced(
            x, onehot.sum(0), onehot.T @ xl, onehot.T @ (xl * xl), (xl * valid).sum(0),
            valid.sum().reshape(1))
        safe = torch.clamp(counts, min=1.0)[:, None]
        means = sums / safe
        var = sq / safe - means * means
        col_mean = col_sum / n_valid
        (col_ss,) = _reduced(x, (((xl - col_mean) * valid) ** 2).sum(0))
        self.epsilon_ = float(self.var_smoothing * torch.max(col_ss / n_valid))
        var = var + self.epsilon_

        self.classes_ = self.__wrap(classes, x)
        self.theta_ = self.__wrap(means, x)
        self.var_ = self.__wrap(var, x)
        self.class_count_ = self.__wrap(counts, x)
        if self.priors is None:
            prior = counts / counts.sum()
        else:
            prior = self.priors._global().to(dev)
            if prior.shape[0] != k:
                raise ValueError("Number of priors must match number of classes.")
            if not np.isclose(float(prior.sum()), 1.0):
                raise ValueError("The sum of the priors should be 1.")
        self.class_prior_ = self.__wrap(prior, x)
        return self

    def partial_fit(self, x: DNDarray, y: DNDarray, classes=None) -> "GaussianNB":
        """Incremental fit on a batch (reference gaussianNB.py `partial_fit`;
        the moment merge of Chan et al.)."""
        if self.theta_ is None:
            if classes is None:
                raise ValueError("classes must be passed on the first call to partial_fit")
            return self.fit(x, y, _classes=np.asarray(
                classes.numpy() if isinstance(classes, DNDarray) else classes))
        old_n = self.class_count_._global()
        old_mu = self.theta_._global()
        old_var = self.var_._global() - self.epsilon_

        tmp = GaussianNB(var_smoothing=self.var_smoothing).fit(x, y)
        new_classes, ref_classes = tmp.classes_.numpy(), self.classes_.numpy()
        if not np.array_equal(np.intersect1d(new_classes, ref_classes), new_classes):
            raise ValueError("partial_fit batch contains unseen classes")
        idx = torch.as_tensor(np.searchsorted(ref_classes, new_classes), device=old_n.device)
        b_n = torch.zeros_like(old_n).index_copy_(0, idx, tmp.class_count_._global())
        b_mu = torch.zeros_like(old_mu).index_copy_(0, idx, tmp.theta_._global())
        b_var = torch.zeros_like(old_var).index_copy_(0, idx, tmp.var_._global() - tmp.epsilon_)

        n_tot = old_n + b_n
        safe = torch.clamp(n_tot, min=1.0)
        mu_tot = (old_n[:, None] * old_mu + b_n[:, None] * b_mu) / safe[:, None]
        ssd = (old_n[:, None] * old_var + b_n[:, None] * b_var
               + (old_n * b_n / safe)[:, None] * (old_mu - b_mu) ** 2)
        var_tot = ssd / safe[:, None]

        self.epsilon_ = max(self.epsilon_, tmp.epsilon_)
        self.class_count_ = self.__wrap(n_tot, x)
        self.theta_ = self.__wrap(mu_tot, x)
        self.var_ = self.__wrap(var_tot + self.epsilon_, x)
        if self.priors is None:
            self.class_prior_ = self.__wrap(n_tot / n_tot.sum(), x)
        return self

    def __joint_log_likelihood(self, x: DNDarray):
        """(x's rows as split, log P(c) + Σ log N(x_i; μ_c, σ_c²)) (reference
        gaussianNB.py:391)."""
        if x.split not in (None, 0):
            x = x.resplit(0)
        xl = x.larray.to(torch.float64)
        mu = self.theta_._global().to(xl.device)
        var = self.var_._global().to(xl.device)
        prior = self.class_prior_._global().to(xl.device)
        head = torch.log(prior)[None, :] - 0.5 * torch.sum(torch.log(2.0 * math.pi * var),
                                                            dim=1)[None, :]
        k, d = mu.shape
        bs = max(1, _BLOCK_BUDGET // max(1, k * d * 8))
        quad = torch.empty((xl.shape[0], k), dtype=torch.float64, device=xl.device)
        for s in range(0, xl.shape[0], bs):
            diff = xl[s:s + bs, None, :] - mu[None, :, :]
            quad[s:s + bs] = -0.5 * torch.sum(diff * diff / var[None, :, :], dim=2)
        return x, head + quad

    def predict(self, x: DNDarray) -> DNDarray:
        """The most probable class of each sample (reference gaussianNB.py:480)."""
        if self.theta_ is None:
            raise RuntimeError("fit needs to be called before predict")
        x, jll = self.__joint_log_likelihood(x)
        classes = self.classes_._global().to(jll.device)
        pred = classes[torch.argmax(jll, dim=1)]
        return DNDarray(pred, (x.shape[0],), self.classes_.dtype, x.split, x.device, x.comm,
                        True)

    def predict_log_proba(self, x: DNDarray) -> DNDarray:
        """Log class probabilities through logsumexp (reference
        gaussianNB.py:407)."""
        x, jll = self.__joint_log_likelihood(x)
        log_prob = jll - torch.logsumexp(jll, dim=1, keepdim=True)
        return DNDarray(log_prob, (x.shape[0], log_prob.shape[1]), types.float64, x.split,
                        x.device, x.comm, True)

    def predict_proba(self, x: DNDarray) -> DNDarray:
        """Class probabilities (reference gaussianNB.py:537)."""
        lp = self.predict_log_proba(x)
        return DNDarray(torch.exp(lp.larray), lp.shape, lp.dtype, lp.split, lp.device, lp.comm,
                        True)
