"""Column moments (mean and M2 over axis 0) from one read of X.

Counterpart of ``heat_tpu/core/pallas_moments.py``. The kernel
(``csrc/moments.cu``) replaces ``_moments_kernel`` there: per-column
(count, mean, M2) of the first ``lim`` rows, blocks over row ranges merged
by the Chan/Welford rule in a fixed order, X read once. It is bound by the
bytes of X over the card's memory rate; the source says how its design
meets that.

On a CPU tensor :func:`column_moments` computes :func:`column_moments_plain`,
the same function in plain torch, which is also the kernel's oracle. On a
CUDA tensor it launches the kernel or raises.

Across ranks the per-rank moments merge in closed form with two
allreduces (:func:`sharded_merge`, the JAX package's
``sharded_column_moments`` :172-209).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .. import _build

__all__ = [
    "chan_merge",
    "column_moments",
    "column_moments_plain",
    "pallas_moments_applicable",
    "sharded_merge",
]

_MAX_D = 4096
_COLS = 32  # columns per block (csrc/moments.cu kCols)
_ROWS_MIN = 64  # rows a block streams at least: 8 warps x 8-row groups
_TARGET_BLOCKS = 2048

_SIGNATURES = {
    "heat_moments_f32": [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p,
    ],
}


def chan_merge(na, mean_a, m2_a, nb, mean_b, m2_b):
    """Chan/Welford pairwise combine of two (count, mean, M2) carries, a copy
    of the JAX package's ``chan_merge`` (:44-61). An empty pair passes the
    left side through unchanged."""
    tot = na + nb
    if float(tot) == 0.0:
        return tot, mean_a, m2_a
    delta = mean_b - mean_a
    mean = mean_a + delta * (nb / tot)
    m2 = m2_a + m2_b + delta * delta * (na * nb / tot)
    return tot, mean, m2


def column_moments_plain(x: torch.Tensor, lim: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean (d,), M2 (d,)) of the first ``lim`` rows of ``x`` in plain torch
    (two passes)."""
    lim = x.shape[0] if lim is None else lim
    xv = x[:lim]
    if lim == 0:
        z = torch.zeros(x.shape[1], dtype=x.dtype, device=x.device)
        return z, z.clone()
    mean = xv.mean(dim=0)
    dev = xv - mean
    return mean, (dev * dev).sum(dim=0)


def column_moments(x: torch.Tensor, lim: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean (d,), M2 (d,)) over axis 0 of an (m, d) f32 tensor, counting
    only the first ``lim`` rows (default: all). The kernel on the card, the
    plain version on the CPU."""
    if x.ndim != 2:
        raise ValueError(f"column_moments needs a 2-D tensor, got {x.ndim}-D")
    m, d = x.shape
    lim = m if lim is None else int(lim)
    if not 0 <= lim <= m:
        raise ValueError(f"lim={lim} outside [0, {m}]")
    if x.device.type == "cpu":
        return column_moments_plain(x, lim)
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("column_moments kernel needs a contiguous float32 tensor")
    if d > _MAX_D:
        raise ValueError(f"column_moments kernel needs d <= {_MAX_D}, got {d}")
    mean = torch.zeros(d, dtype=torch.float32, device=x.device)
    m2 = torch.zeros(d, dtype=torch.float32, device=x.device)
    if lim == 0 or d == 0:
        return mean, m2
    col_tiles = -(-d // _COLS)
    parts = max(1, min(-(-lim // _ROWS_MIN), _TARGET_BLOCKS // col_tiles))
    rows = -(-lim // parts)
    parts = -(-lim // rows)
    part_mean = torch.empty((parts, d), dtype=torch.float32, device=x.device)
    part_m2 = torch.empty((parts, d), dtype=torch.float32, device=x.device)
    part_cnt = torch.empty((parts,), dtype=torch.float32, device=x.device)
    lib = _build.library("moments", _SIGNATURES)
    with torch.cuda.device(x.device):  # launch on the tensor's card
        rc = lib.heat_moments_f32(
            x.data_ptr(), d, lim, parts, rows, part_mean.data_ptr(), part_m2.data_ptr(),
            part_cnt.data_ptr(), mean.data_ptr(), m2.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(lib, rc, "moments kernel")
    _build.count_launch("moments")
    return mean, m2


def sharded_merge(comm, n_local: int, mean_s: torch.Tensor, m2_s: torch.Tensor,
                  n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global (mean, M2) from every rank's (count, mean, M2), in closed form
    with two allreduces: ``mean_g = Σ n_s mean_s / n`` and
    ``M2_g = Σ (M2_s + n_s (mean_s - mean_g)^2)``."""
    mean_g = comm.allreduce(mean_s * float(n_local)) / float(n)
    dlt = mean_s - mean_g
    m2_g = comm.allreduce(m2_s + float(n_local) * dlt * dlt)
    return mean_g, m2_g


def pallas_moments_applicable(comm_size: int, split, ndim: int, axis, d: int, dtype) -> bool:
    """The JAX package's gate for its moments kernel without the backend
    test: f32, 2-D, axis 0, d <= 4096, and one rank or rows split."""
    return (
        (comm_size == 1 or split == 0)
        and ndim == 2
        and axis == 0
        and d <= _MAX_D
        and dtype == torch.float32
    )
