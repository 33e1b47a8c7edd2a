"""Distributed SVD (counterpart of ``heat_tpu/core/linalg/svd.py``).

A tall split matrix runs its no-gather QR (TSQR for split 0, CholeskyQR2 for
split 1, :mod:`.qr`) and then the SVD of the small n × n R factor on every
rank; ``U = Q·U_R`` is one :func:`matmul`. A wide split matrix runs the tall
path on its transpose and swaps the factors. One rank, or a replicated
input, takes one ``torch.linalg.svd``.

On the card every SVD asks cuSOLVER for ``gesvd``: torch's default CUDA
routine (``gesvdj``) leaves U about 5e-4 (Frobenius) from orthogonal on a
1,000,000 × 256 f32 matrix, over the 10 n 2⁻²⁴ bound that ``gesvd`` meets
(``chip_smoke.py``'s svd row times and checks both; PERF.md §5 has the
H100's numbers).
"""

from __future__ import annotations

import collections

import torch

from .. import types
from ..dndarray import DNDarray
from .basics import _from_global, _replicated, matmul, transpose
from .qr import qr

__all__ = ["svd"]

SVD = collections.namedtuple("SVD", "U, S, V")


def _svd(t: torch.Tensor, full_matrices: bool = False, compute_uv: bool = True):
    """``torch.linalg.svd`` (``svdvals``), with cuSOLVER's ``gesvd`` on the card."""
    routine = {"driver": "gesvd"} if t.is_cuda else {}
    if not compute_uv:
        return torch.linalg.svdvals(t, **routine)
    return torch.linalg.svd(t, full_matrices=full_matrices, **routine)


def svd(a: DNDarray, full_matrices: bool = False, compute_uv: bool = True):
    """Singular value decomposition ``a = U @ diag(S) @ V.T``; the singular
    values alone (a DNDarray) with ``compute_uv=False``.
    ``full_matrices=True`` takes the general path."""
    if not isinstance(a, DNDarray):
        raise TypeError(f"'a' must be a DNDarray, but was {type(a)}")
    if a.ndim != 2:
        raise ValueError(f"'a' must be 2-dimensional, but has {a.ndim} dimensions")

    m, n = a.shape
    dt = types.promote_types(a.dtype, types.float32)
    tdt = dt.torch_type()
    distributed = a.comm.size > 1 and a.split is not None

    if compute_uv and distributed and not full_matrices:
        if n > m:
            # A = U S Vᵀ  <=>  Aᵀ = V S Uᵀ, and Aᵀ is tall
            res = svd(transpose(a), full_matrices=False, compute_uv=True)
            return SVD(res.V, res.S, res.U)
        q, r = qr(a)
        u_r, s, vt = _svd(r._global())
        u = matmul(q, _replicated(u_r.to(tdt), a, dt))
        return SVD(u, _replicated(s.to(tdt), a, dt), _replicated(vt.t().to(tdt), a, dt))

    if not compute_uv and distributed:
        # the singular values are R's, and transpose-invariant
        if n > m:
            a = transpose(a)
        _, r = qr(a, calc_q=False)
        return _replicated(_svd(r._global().to(tdt), compute_uv=False), a, dt)

    log = a._global().to(tdt)
    if not compute_uv:
        return _replicated(_svd(log, compute_uv=False), a, dt)
    u, s, vt = _svd(log, full_matrices)
    return SVD(_from_global(u, a.split if a.split == 0 else None, a, dt),
               _replicated(s, a, dt),
               _from_global(vt.t(), a.split if a.split == 1 else None, a, dt))
