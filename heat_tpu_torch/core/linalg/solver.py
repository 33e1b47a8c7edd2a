"""Iterative solvers (counterpart of ``heat_tpu/core/linalg/solver.py``):
conjugate gradients and Lanczos tridiagonalisation.

A split-0 ``A`` stays split: each matvec is this rank's rows times the
vector and one ``allgather`` of the n-vector (a split-1 ``A`` is resplit to
its rows once, one ``all_to_all``); nothing gathers the n × n matrix. An
operator that exposes ``_matvec_spec`` (a ``sparse.SparseDNDarray``) gives
its own matvec: the shard-local CSR product and one allreduce of the
n-vector. The vectors are whole on every rank. The JAX package runs each
solve as one compiled loop; here the loop is on the host and reads one
scalar an iteration (CG's ``r·r``, Lanczos' ``β``). The breakdown restart
of Lanczos draws ``normal(fold_in(PRNGKey(0), i), (n,))`` with the port's
threefry, the JAX package's vector. The ``checkpoint_every``/``resume``
windows come with the resilience layer (ROADMAP §1 item 13).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .. import _threefry, cuda_random, types
from ..dndarray import DNDarray
from ..factories import _from_global

__all__ = ["cg", "lanczos"]


def _not_ported(checkpoint_every, resume) -> None:
    if checkpoint_every is not None or resume:
        raise NotImplementedError(
            "the checkpoint_every/resume windows come with the resilience layer "
            "(ROADMAP item 13)")


def _is_operator(A) -> bool:
    return isinstance(A, DNDarray) or hasattr(A, "_matvec_spec")


def _matvec(A, dtype: torch.dtype) -> Callable[[torch.Tensor], torch.Tensor]:
    """``x -> A @ x`` for a whole vector ``x``, the result whole on every
    rank."""
    if not isinstance(A, DNDarray):
        return A._matvec_spec(types.canonical_heat_type(dtype))
    if A.split is not None and A.comm.size > 1:
        rows = (A if A.split == 0 else A.resplit(0)).larray.to(dtype)
        comm, n = A.comm, A.shape[0]
        return lambda x: comm.allgather(rows @ x, 0, n)
    a = A.larray.to(dtype)
    return lambda x: a @ x


def cg(A: DNDarray, b: DNDarray, x0: DNDarray, out: Optional[DNDarray] = None, *,
       checkpoint_every: Optional[int] = None, checkpoint_path: Optional[str] = None,
       resume: bool = False) -> DNDarray:
    """Conjugate gradients for a symmetric positive definite ``A x = b``
    (reference solver.py:127): at most n iterations, until ``r·r < 1e-20``.
    A non-finite iterate raises ``RuntimeError``."""
    _not_ported(checkpoint_every, resume)
    if not (_is_operator(A) and isinstance(b, DNDarray) and isinstance(x0, DNDarray)):
        raise TypeError("cg expects DNDarray (or sparse operator) A, and DNDarray b and x0")
    if A.ndim != 2:
        raise RuntimeError(f"cg expects a 2-D matrix A, got {A.ndim}-D")
    if b.ndim != 1:
        raise RuntimeError(f"cg expects a 1-D right-hand side b, got {b.ndim}-D")
    if x0.ndim != 1:
        raise RuntimeError(f"cg expects a 1-D initial guess x0, got {x0.ndim}-D")
    n = A.shape[0]
    dt = types.promote_types(types.promote_types(A.dtype, b.dtype),
                             types.promote_types(x0.dtype, types.float32))
    tdt = dt.torch_type()
    matvec = _matvec(A, tdt)
    x = x0._global().to(tdt)
    r = b._global().to(tdt) - matvec(x)
    p = r
    rs = torch.dot(r, r)
    it = 0
    while it < n and float(rs) >= 1e-20:
        Ap = matvec(p)
        alpha = rs / torch.dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        rs_new = torch.dot(r, r)
        p = r + (rs_new / rs) * p
        rs = rs_new
        it += 1
    if not bool(torch.isfinite(x).all()):
        raise RuntimeError(
            "cg broke down (non-finite iterate) — A must be symmetric positive definite")
    res = _from_global(x, x0.split, x0.device, x0.comm, dt)
    if out is not None:
        out.larray = res.larray
        return out
    return res


def lanczos(A: DNDarray, m: int, v0: Optional[DNDarray] = None,
            V_out: Optional[DNDarray] = None, T_out: Optional[DNDarray] = None, *,
            checkpoint_every: Optional[int] = None, checkpoint_path: Optional[str] = None,
            resume: bool = False) -> Tuple[DNDarray, DNDarray]:
    """Lanczos tridiagonalisation with full reorthogonalisation against the
    ``(m, n)`` basis (reference solver.py:549): ``(V, T)``, ``V`` the n × m
    orthonormal Krylov basis split as ``A`` and ``T`` the m × m tridiagonal
    matrix, in ``A``'s inexact type. Without ``v0`` the start is
    ``numpy.random.default_rng(0).standard_normal(n)``; a breakdown
    (``β ≤ 1e-6``, ``1e-13`` in float64) restarts from the JAX package's
    ``normal(fold_in(PRNGKey(0), i), (n,))``."""
    _not_ported(checkpoint_every, resume)
    if not _is_operator(A):
        raise TypeError(f"A needs to be a ht.DNDarray or sparse operator, but was {type(A)}")
    if A.ndim != 2 or A.shape[0] != A.shape[1]:
        raise RuntimeError("A needs to be a square matrix")
    if not isinstance(m, int) or m <= 0:
        raise TypeError(f"m must be a positive integer, got {m}")
    n = A.shape[0]
    dt = types.promote_types(A.dtype, types.float32)
    tdt = dt.torch_type()
    dev = A.larray.device if isinstance(A, DNDarray) else A.values.device
    matvec = _matvec(A, tdt)
    if v0 is None:
        v = torch.as_tensor(np.random.default_rng(0).standard_normal(n), device=dev).to(tdt)
    else:
        v = v0._global().to(tdt)
    eps = 1e-13 if tdt == torch.float64 else 1e-6
    key = _threefry.prng_key(0)

    v = v / torch.linalg.vector_norm(v)
    basis = torch.zeros((m, n), dtype=tdt, device=dev)
    basis[0] = v
    alphas = torch.zeros(m, dtype=tdt, device=dev)
    betas = torch.zeros(m, dtype=tdt, device=dev)
    w = matvec(v)
    alphas[0] = torch.dot(w, v)
    w = w - alphas[0] * v
    for i in range(1, m):
        beta = torch.linalg.vector_norm(w)
        if float(beta) > eps:
            v = w / beta
        else:
            v = _threefry.normal(_threefry.fold_in(key, i), _threefry.Slice.whole((n,)), tdt,
                                 cuda_random.draw, dev)
            beta = torch.zeros((), dtype=tdt, device=dev)
        prev = basis[:i]
        v = v - prev.t() @ (prev @ v)
        v = v / torch.linalg.vector_norm(v)
        basis[i] = v
        betas[i] = beta
        w = matvec(v)
        alphas[i] = torch.dot(w, v)
        w = w - alphas[i] * v - beta * basis[i - 1]
    T = torch.diag(alphas) + torch.diag(betas[1:], 1) + torch.diag(betas[1:], -1)
    V = _from_global(basis.t().contiguous(), A.split, A.device, A.comm, dt)
    T = _from_global(T, None, A.device, A.comm, dt)
    if V_out is not None:
        V_out.larray, T_out.larray = V.larray, T.larray
        return V_out, T_out
    return V, T
