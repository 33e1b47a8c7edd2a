"""Lloyd's K-Means, and the judge of a program's fit.

The judge reads the fit's outputs and checks them against what they claim,
in float64: every label names a nearest center (``label_gap``), the fit ran
the passes it was asked for (``iter_gap``), and its centers are one Lloyd
pass from the centers before them: the first pass from the initial centers
(``first_gap``) and the last pass from the program's own centers after all
but one pass (``last_gap``), each the means of the rows nearest to the
centers before; every center counts alike, an empty cluster's too, which
keeps its center. It does not fit again to compare centers: over 30 passes a
row that lies within rounding of a boundary can fall to either side, and
two correct f32 fits from one start end apart; nor does it ask the last
centers to be a fixed point, which a fit that has not converged is not.
"""

from typing import Callable, Dict, Optional, Tuple

import torch

from .precision import matmul_t

NAMES = ("label_gap", "first_gap", "last_gap", "iter_gap")
Reduce = Optional[Callable[[torch.Tensor, str], torch.Tensor]]


def _d2(x: torch.Tensor, c: torch.Tensor, precision: str) -> torch.Tensor:
    x2 = (x * x).sum(dim=1, keepdim=True)
    c2 = (c * c).sum(dim=1)[None, :]
    return x2 + c2 - 2.0 * matmul_t(x, c, precision)


def lloyd_fit(x: torch.Tensor, init: torch.Tensor, passes: int, precision: str = "f32",
              block_rows: int = 1 << 20) -> Tuple[torch.Tensor, torch.Tensor]:
    """``passes`` Lloyd iterations from ``init`` (an empty cluster keeps its
    center), then the labels of the final centers: (centers, labels). The
    scores' product runs in ``precision`` (``"tf32"`` is the control), the
    sums in float64."""
    c = init.float().clone()
    k = c.shape[0]
    for _ in range(passes):
        sums = torch.zeros((k, x.shape[1]), dtype=torch.float64, device=x.device)
        counts = torch.zeros((k,), dtype=torch.float64, device=x.device)
        for s in range(0, x.shape[0], block_rows):
            xb = x[s:s + block_rows]
            lab = _d2(xb, c, precision).argmin(dim=1)
            sums.index_add_(0, lab, xb.double())
            counts += torch.bincount(lab, minlength=k).double()
        c = torch.where(counts[:, None] > 0, sums / counts.clamp(min=1.0)[:, None],
                        c.double()).float()
    labels = torch.cat([_d2(x[s:s + block_rows], c, precision).argmin(dim=1)
                        for s in range(0, x.shape[0], block_rows)])
    return c, labels


def _lloyd_step(x: torch.Tensor, c: torch.Tensor, block_rows: int, reduce: Reduce
                ) -> torch.Tensor:
    """One exact Lloyd pass from ``c``: the float64 means of the rows
    nearest to each center (a center no row is nearest to stays)."""
    cd = c.double()
    k = cd.shape[0]
    sums = torch.zeros((k, x.shape[1]), dtype=torch.float64, device=x.device)
    counts = torch.zeros((k,), dtype=torch.float64, device=x.device)
    for s in range(0, x.shape[0], block_rows):
        xd = x[s:s + block_rows].double()
        near = ((xd * xd).sum(dim=1, keepdim=True) + (cd * cd).sum(dim=1)[None, :]
                - 2.0 * (xd @ cd.T)).argmin(dim=1)
        sums.index_add_(0, near, xd)
        counts += torch.bincount(near, minlength=k).double()
    if reduce is not None:
        sums, counts = reduce(sums, "sum"), reduce(counts, "sum")
    return torch.where(counts[:, None] > 0, sums / counts.clamp(min=1.0)[:, None], cd)


def _std(x: torch.Tensor, block_rows: int, reduce: Reduce) -> float:
    m = torch.zeros((3,), dtype=torch.float64, device=x.device)
    for s in range(0, x.shape[0], block_rows):
        xd = x[s:s + block_rows].double()
        m += torch.stack([xd.sum(), (xd * xd).sum(), xd.new_tensor(float(xd.numel()))])
    if reduce is not None:
        m = reduce(m, "sum")
    mean = m[0] / m[2]
    return float(torch.sqrt(torch.clamp(m[1] / m[2] - mean * mean, min=0.0)))


def judge_fit(x: torch.Tensor, init: torch.Tensor, first: torch.Tensor, before_last: torch.Tensor,
              centers: torch.Tensor, labels: torch.Tensor, n_iter: int, passes: int,
              block_rows: int = 1 << 20, reduce: Reduce = None) -> Dict[str, float]:
    """The fit's four numbers (module docstring), each 0 for an exact fit:

    - ``label_gap``: the widest excess of a row's distance to its labelled
      center over its distance to the nearest, over |x|^2 + mean |c|^2;
    - ``first_gap``: the widest gap, over every center and feature, between
      ``first`` (the centers after one pass from ``init``) and one exact
      pass from ``init``, over the data's standard deviation;
    - ``last_gap``: the same between ``centers`` and one exact pass from
      ``before_last`` (the centers after ``passes - 1`` passes);
    - ``iter_gap``: how far the fit's pass count is from ``passes``.

    ``x`` and ``labels`` are this rank's rows; ``reduce(t, op)`` ("sum" or
    "max") combines a float64 tensor over the ranks, where there are
    several. nan where a shape is wrong or a number is not finite."""
    k, d = init.shape
    nan = {name: float("nan") for name in NAMES}
    for c in (first, before_last, centers):
        if tuple(c.shape) != (k, d) or not bool(torch.isfinite(c).all()):
            return nan
    lab_all = labels.long()
    if tuple(labels.shape) != (x.shape[0],) or bool(((lab_all < 0) | (lab_all >= k)).any()):
        return nan
    cd = centers.double()
    c2 = (cd * cd).sum(dim=1)
    scale = c2.mean()
    label_gap = torch.zeros((1,), dtype=torch.float64, device=x.device)
    for s in range(0, x.shape[0], block_rows):
        xd = x[s:s + block_rows].double()
        lab = lab_all[s:s + block_rows]
        x2 = (xd * xd).sum(dim=1, keepdim=True)
        d2 = x2 + c2[None, :] - 2.0 * (xd @ cd.T)
        excess = d2.gather(1, lab[:, None]).squeeze(1) - d2.min(dim=1).values
        label_gap = torch.maximum(label_gap, (excess / (x2.squeeze(1) + scale)).max()[None])
    if reduce is not None:
        label_gap = reduce(label_gap, "max")
    std = _std(x, block_rows, reduce)

    def step_gap(prev: torch.Tensor, got: torch.Tensor) -> float:
        means = _lloyd_step(x, prev, block_rows, reduce)
        return float((means - got.double()).abs().max()) / std

    return {"label_gap": float(label_gap), "first_gap": step_gap(init, first),
            "last_gap": step_gap(before_last, centers),
            "iter_gap": float(abs(int(n_iter) - int(passes)))}
