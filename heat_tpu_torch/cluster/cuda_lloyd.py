"""The fused Lloyd (K-Means) accumulation pass and the fit loop around it.

Counterpart of ``heat_tpu/cluster/pallas_lloyd.py``. The kernel
(``csrc/lloyd.cu``) replaces ``_lloyd_kernel`` there: for each row tile
the scores ``|c|^2 - 2 x.c`` against all k centers (pad centers masked),
the argmin and the valid-row mask, and the per-center sums (k, d) and
counts (k,), in one pass over X that never writes the (n, k) scores. Blocks
accumulate their own partials and a second pass adds them in a fixed order,
with no float atomics, so two runs give bit-identical centers and labels.

Two kernels, chosen by shape. ``lloyd_tc`` (a persistent grid, X tiles by
bulk tensor copies, the scores on the tensor cores in 3xTF32) takes
d % 4 == 0 (16-byte rows for the copies), 16-byte aligned data and
1 <= lim < 2^31 - 64 (a copy's row coordinate is an int); at the main
path's 2,000,000 x 64, k = 64 it is bound by reading X. ``lloyd_partial``
(f32 FMAs on the CUDA cores) takes every other shape, and any shape with
``_old_kernel=True``, for comparisons. The source says how each design
meets its bound.

On a CPU tensor :func:`lloyd_update` computes :func:`lloyd_update_plain`,
the same function in plain torch, which is also the kernel's oracle. On a
CUDA tensor it launches the kernel or raises.

:func:`lloyd_fit` is the fit loop of ``lloyd_fit_pallas`` (:148-197) and
its sharded twin (:206-279): one accumulation pass per iteration, one
allreduce of the sums and counts when the rows are split over ranks, and
the host reads the squared center shift every iteration to test it
against ``tol``, as the reference Heat does.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .. import _build

__all__ = ["lloyd_fit", "lloyd_update", "lloyd_update_plain", "pallas_lloyd_applicable"]

_MAX_D = 512
_MAX_K = 1024
_TILE_ROWS = 64  # csrc/lloyd.cu BM and TC_BM
_BLOCKS_PER_SM = 4  # csrc/lloyd.cu kBlocksPerSM: all resident at once
_TC_BLOCKS_PER_SM = 2  # lloyd_tc: at most (csrc/lloyd.cu tc_plan)
_TC_MAX_ROWS = 2 ** 31 - 64
_SCRATCH_BYTES = 256 << 20  # bound on the blocks' (k, d) partial sums

_SIGNATURES = {
    "heat_lloyd_f32": [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p,
    ],
}
_SIGNATURES["heat_lloyd_tc"] = _SIGNATURES["heat_lloyd_f32"]


def lloyd_update_plain(x: torch.Tensor, centers: torch.Tensor,
                       lim: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sums (k, d), counts (k,)) of one accumulation pass in plain torch."""
    lim = x.shape[0] if lim is None else lim
    xv = x[:lim]
    k = centers.shape[0]
    c2 = (centers * centers).sum(dim=1)
    scores = c2[None, :] - 2.0 * (xv @ centers.T)
    labels = torch.argmin(scores, dim=1)
    sums = torch.zeros_like(centers).index_add_(0, labels, xv)
    counts = torch.bincount(labels, minlength=k).to(centers.dtype)
    return sums, counts


def lloyd_update(x: torch.Tensor, centers: torch.Tensor, lim: Optional[int] = None,
                 _old_kernel: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """One accumulation pass over the first ``lim`` rows of (m, d) ``x``
    against (k, d) ``centers``. A kernel on the card, the plain version
    on the CPU."""
    if x.ndim != 2 or centers.ndim != 2 or x.shape[1] != centers.shape[1]:
        raise ValueError(
            f"lloyd_update needs (m, d) and (k, d) tensors, got {tuple(x.shape)}, {tuple(centers.shape)}"
        )
    m, d = x.shape
    k = centers.shape[0]
    lim = m if lim is None else int(lim)
    if not 0 <= lim <= m:
        raise ValueError(f"lim={lim} outside [0, {m}]")
    if x.device != centers.device:
        raise ValueError(f"x and centers lie on different devices: {x.device}, {centers.device}")
    if x.device.type == "cpu":
        return lloyd_update_plain(x, centers, lim)
    if x.dtype != torch.float32 or centers.dtype != torch.float32:
        raise ValueError("lloyd kernel needs float32 tensors")
    if d > _MAX_D or k > _MAX_K:
        raise ValueError(f"lloyd kernel needs d <= {_MAX_D} and k <= {_MAX_K}, got d={d}, k={k}")
    x, centers = x.contiguous(), centers.contiguous()
    tc = (not _old_kernel and d % 4 == 0 and 1 <= lim < _TC_MAX_ROWS
          and x.data_ptr() % 16 == 0 and centers.data_ptr() % 16 == 0)
    tiles = max(1, -(-lim // _TILE_ROWS))
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    per_sm = _TC_BLOCKS_PER_SM if tc else _BLOCKS_PER_SM
    blocks = max(1, min(tiles, per_sm * sms, _SCRATCH_BYTES // max(1, k * d * 4)))
    sums_part = torch.empty((blocks, k, d), dtype=torch.float32, device=x.device)
    cnt_part = torch.empty((blocks, k), dtype=torch.int32, device=x.device)
    sums = torch.empty((k, d), dtype=torch.float32, device=x.device)
    counts = torch.empty((k,), dtype=torch.float32, device=x.device)
    lib = _build.library("lloyd", _SIGNATURES)
    entry = lib.heat_lloyd_tc if tc else lib.heat_lloyd_f32
    with torch.cuda.device(x.device):  # launch on the tensor's card
        rc = entry(x.data_ptr(), d, lim, centers.data_ptr(), k, blocks, sums_part.data_ptr(),
                   cnt_part.data_ptr(), sums.data_ptr(), counts.data_ptr(),
                   torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, rc, "lloyd kernel")
    _build.count_launch("lloyd")
    return sums, counts


def lloyd_fit(x: torch.Tensor, centers0: torch.Tensor, max_iter: int, tol: float,
              comm=None, update=lloyd_update) -> Tuple[torch.Tensor, int]:
    """Lloyd iterations from ``centers0`` until the squared center shift is
    no longer above ``tol`` or ``max_iter`` is reached; returns the centers
    and the number of iterations. ``comm`` (when its size is above 1) sums
    the passes of all ranks, whose rows together form the data. ``update``
    is the accumulation pass: :func:`lloyd_update` inside the kernel's gate,
    :func:`lloyd_update_plain` outside it."""
    tol32 = float(torch.tensor(tol, dtype=centers0.dtype))
    c = centers0.clone()
    it = 0
    shift = float("inf")
    while it < max_iter and shift > tol32:
        sums, counts = update(x, c)
        if comm is not None and comm.size > 1:
            comm.allreduce(sums)
            comm.allreduce(counts)
        cnt = counts[:, None]
        new_c = torch.where(cnt > 0, sums / torch.clamp(cnt, min=1.0), c)
        shift = float(((new_c - c) ** 2).sum())
        c = new_c
        it += 1
    return c, it


def pallas_lloyd_applicable(comm_size: int, split, d: int, k: int, dtype) -> bool:
    """The JAX package's gate for its Lloyd kernel without the backend test:
    f32, d <= 512, k <= 1024, and one rank or rows split."""
    return (
        (comm_size == 1 or split == 0)
        and d <= _MAX_D
        and k <= _MAX_K
        and dtype == torch.float32
    )
