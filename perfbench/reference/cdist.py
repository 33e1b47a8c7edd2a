"""Euclidean distances, and the judge of a program's distance rows."""

from typing import Callable

import torch

from .precision import matmul_t


def distances(x: torch.Tensor, y: torch.Tensor, precision: str = "f32") -> torch.Tensor:
    """(m, n) distances between the rows of x and y in GEMM form,
    ``sqrt(max(|x|^2 + |y|^2 - 2 x.y, 0))``, the product in ``precision``
    and the norms in f32. ``"tf32"`` is the control."""
    x2 = (x * x).sum(dim=1, keepdim=True)
    y2 = (y * y).sum(dim=1, keepdim=True).T
    return torch.sqrt(torch.clamp(x2 + y2 - 2.0 * matmul_t(x, y, precision).float(), min=0.0))


def dist_gap(x: torch.Tensor, y: torch.Tensor, rows: Callable[[int, int], torch.Tensor],
             block_rows: int = 2048) -> float:
    """The widest gap between the squared distances that ``rows(s, e)``
    gives (rows s to e of x against all of y) and the exact ones, each over
    |x_i|^2 + |y_j|^2: the scale of the rounding of any f32 form of
    |x|^2 + |y|^2 - 2 x.y. Computed in float64, ``block_rows`` rows at a
    time; nan where a block has the wrong shape or a non-finite entry."""
    yd = y.double()
    y2 = (yd * yd).sum(dim=1)[None, :]
    worst = 0.0
    for s in range(0, x.shape[0], block_rows):
        e = min(s + block_rows, x.shape[0])
        got = rows(s, e)
        if tuple(got.shape) != (e - s, y.shape[0]):
            return float("nan")
        xd = x[s:e].double()
        x2 = (xd * xd).sum(dim=1, keepdim=True)
        exact = torch.clamp(x2 + y2 - 2.0 * (xd @ yd.T), min=0.0)
        got = got.double()
        gap = ((got * got - exact).abs() / (x2 + y2)).max().item()
        if gap != gap or gap == float("inf"):
            return float("nan")
        worst = max(worst, gap)
    return worst
