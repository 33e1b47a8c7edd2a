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
threefry, the JAX package's vector.

``checkpoint_every=k`` runs the iteration in windows of ``k`` steps and
saves the carry after each to ``checkpoint_path``
(:func:`heat_tpu_torch.resilience.save_checkpoint`, the JAX package's
records: CG's ``[x, r, p]`` with ``it`` and ``rsold``, Lanczos'
``[V, alphas, betas, w]`` with ``i``); ``resume=True`` continues a killed
solve from the last window, bit for bit the uninterrupted one (the same
per-iteration arithmetic, and the restart draw depends only on ``i``).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .. import _threefry, cuda_random, types
from ..dndarray import DNDarray
from ..factories import _from_global

__all__ = ["cg", "lanczos"]


def _windows(checkpoint_every, checkpoint_path, resume) -> Optional[int]:
    """The validated window length (None: one uninterrupted loop)."""
    if checkpoint_every is None:
        if resume:
            raise ValueError("resume=True requires checkpoint_every")
        return None
    if checkpoint_every <= 0:
        raise ValueError(f"checkpoint_every must be positive, got {checkpoint_every}")
    if not checkpoint_path:
        raise ValueError("checkpoint_every requires checkpoint_path")
    return int(checkpoint_every)


def _load_carry(path: str, algo: str, n_leaves: int, comm, resume: bool):
    """``(leaves, extra)`` of a resumable checkpoint of ``algo``, or None."""
    from ... import resilience

    if not (resume and resilience.checkpoint.exists(path)):
        return None
    leaves, extra = resilience.load_checkpoint(path, comm=comm, with_extra=True)
    if extra.get("algo") != algo or len(leaves) != n_leaves:
        raise resilience.CheckpointError(
            f"{path!r} is a {extra.get('algo')!r} checkpoint, not {algo}")
    return leaves, extra


def _save_carry(path: str, tensors, extra: dict, comm) -> None:
    from ... import resilience

    resilience.save_checkpoint([t.detach().cpu().numpy() for t in tensors], path,
                               extra=extra, comm=comm)


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
    A non-finite iterate raises ``RuntimeError``. ``checkpoint_every``,
    ``checkpoint_path`` and ``resume``: the windows (module docstring)."""
    every = _windows(checkpoint_every, checkpoint_path, resume)
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
    loaded = None if every is None else _load_carry(checkpoint_path, "cg", 3, x0.comm, resume)
    if loaded is not None:
        (x, r, p), extra = loaded
        dev = x0.larray.device
        x, r, p = (torch.as_tensor(np.asarray(t)).to(dev, tdt) for t in (x, r, p))
        rs = torch.tensor(extra["rsold"], dtype=tdt, device=dev)
        it = int(extra["it"])
    else:
        x = x0._global().to(tdt)
        r = b._global().to(tdt) - matvec(x)
        p = r
        rs = torch.dot(r, r)
        it = 0
    while True:
        start = it
        lim = n if every is None else min(it + every, n)
        while it < lim and float(rs) >= 1e-20:
            Ap = matvec(p)
            alpha = rs / torch.dot(p, Ap)
            x = x + alpha * p
            r = r - alpha * Ap
            rs_new = torch.dot(r, r)
            p = r + (rs_new / rs) * p
            rs = rs_new
            it += 1
        if every is None or it == start:
            break  # done, converged, or a window that made no progress
        _save_carry(checkpoint_path, (x, r, p), {"algo": "cg", "it": it, "rsold": float(rs)},
                    x0.comm)
        if it >= n:
            break
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
    ``normal(fold_in(PRNGKey(0), i), (n,))``. ``checkpoint_every``,
    ``checkpoint_path`` and ``resume``: the windows (module docstring)."""
    every = _windows(checkpoint_every, checkpoint_path, resume)
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

    loaded = None if every is None else _load_carry(checkpoint_path, "lanczos", 4, A.comm,
                                                      resume)
    if loaded is not None:
        leaves, extra = loaded
        basis, alphas, betas, w = (torch.as_tensor(np.asarray(t)).to(dev, tdt) for t in leaves)
        first = int(extra["i"])
    else:
        v = v / torch.linalg.vector_norm(v)
        basis = torch.zeros((m, n), dtype=tdt, device=dev)
        basis[0] = v
        alphas = torch.zeros(m, dtype=tdt, device=dev)
        betas = torch.zeros(m, dtype=tdt, device=dev)
        w = matvec(v)
        alphas[0] = torch.dot(w, v)
        w = w - alphas[0] * v
        first = 1
    for i in range(first, m):
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
        if every is not None and ((i - first + 1) % every == 0 or i == m - 1):
            _save_carry(checkpoint_path, (basis, alphas, betas, w),
                        {"algo": "lanczos", "i": i + 1}, A.comm)
    T = torch.diag(alphas) + torch.diag(betas[1:], 1) + torch.diag(betas[1:], -1)
    V = _from_global(basis.t().contiguous(), A.split, A.device, A.comm, dt)
    T = _from_global(T, None, A.device, A.comm, dt)
    if V_out is not None:
        V_out.larray, T_out.larray = V.larray, T.larray
        return V_out, T_out
    return V, T
