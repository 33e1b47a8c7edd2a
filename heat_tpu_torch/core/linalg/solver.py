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

from .. import _threefry, cuda_random, program_cache, types
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


def _kind_key(A, n: int, dtype: torch.dtype) -> tuple:
    """The static configuration of a solver program: the operator's kind
    and layout, its order and the iteration type."""
    return (type(A).__name__, getattr(A, "split", None), n, str(dtype))


def _cg_init(matvec, b: torch.Tensor, x0: torch.Tensor):
    """The CG carry ``(x, r, p, r·r)`` at ``x0`` (site ``cg_init``)."""
    x = x0
    r = b - matvec(x)
    return x, r, r, torch.dot(r, r)


def _cg_window(matvec, x, r, p, rs, it: int, lim: int):
    """CG iterations from ``it`` until ``lim`` or ``r·r < 1e-20`` (site
    ``cg_chunk``, one checkpoint window): the carry and the iteration."""
    # heatlint: disable=HL004 -- the port's loop reads r.r once an iteration
    # on the host (module docstring); the program runs inline, never captured
    while it < lim and float(rs) >= 1e-20:
        Ap = matvec(p)
        alpha = rs / torch.dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        rs_new = torch.dot(r, r)
        p = r + (rs_new / rs) * p
        rs = rs_new
        it += 1
    return x, r, p, rs, it


def _cg_solve(matvec, b: torch.Tensor, x0: torch.Tensor, n: int) -> torch.Tensor:
    """The uninterrupted solve (site ``cg``): at most ``n`` iterations."""
    x, r, p, rs = _cg_init(matvec, b, x0)
    return _cg_window(matvec, x, r, p, rs, 0, n)[0]


def _lanczos_init(matvec, v: torch.Tensor, m: int):
    """The Lanczos carry after the first vector (site ``lanczos_init``):
    ``(basis (m, n), alphas, betas, w)``."""
    n = v.shape[0]
    v = v / torch.linalg.vector_norm(v)
    basis = torch.zeros((m, n), dtype=v.dtype, device=v.device)
    basis[0] = v
    alphas = torch.zeros(m, dtype=v.dtype, device=v.device)
    betas = torch.zeros(m, dtype=v.dtype, device=v.device)
    w = matvec(v)
    alphas[0] = torch.dot(w, v)
    w = w - alphas[0] * v
    return basis, alphas, betas, w


def _lanczos_window(matvec, basis, alphas, betas, w, lo: int, hi: int, eps: float):
    """Lanczos steps ``lo..hi-1`` into ``basis``, ``alphas`` and ``betas``
    (site ``lanczos_chunk``, one checkpoint window); returns the next
    ``w``. A retry recomputes the same rows from the same ``w``."""
    n, dtype, dev = basis.shape[1], basis.dtype, basis.device
    key = _threefry.prng_key(0)
    for i in range(lo, hi):
        beta = torch.linalg.vector_norm(w)
        if float(beta) > eps:
            v = w / beta
        else:
            v = _threefry.normal(_threefry.fold_in(key, i), _threefry.Slice.whole((n,)), dtype,
                                 cuda_random.draw, dev)
            beta = torch.zeros((), dtype=dtype, device=dev)
        prev = basis[:i]
        v = v - prev.t() @ (prev @ v)
        v = v / torch.linalg.vector_norm(v)
        basis[i] = v
        betas[i] = beta
        w = matvec(v)
        alphas[i] = torch.dot(w, v)
        w = w - alphas[i] * v - beta * basis[i - 1]
    return w


def _lanczos_solve(matvec, v: torch.Tensor, m: int, eps: float):
    """The uninterrupted tridiagonalisation (site ``lanczos``)."""
    basis, alphas, betas, w = _lanczos_init(matvec, v, m)
    _lanczos_window(matvec, basis, alphas, betas, w, 1, m, eps)
    return basis, alphas, betas


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
    key = _kind_key(A, n, tdt)
    comm = x0.comm
    if every is None:
        x = program_cache.cached_program("cg", key, lambda: _cg_solve, comm=comm, inline=True)(
            matvec, b._global().to(tdt), x0._global().to(tdt), n)
    else:
        loaded = _load_carry(checkpoint_path, "cg", 3, comm, resume)
        if loaded is not None:
            (x, r, p), extra = loaded
            dev = x0.larray.device
            x, r, p = (torch.as_tensor(np.asarray(t)).to(dev, tdt) for t in (x, r, p))
            rs = torch.tensor(extra["rsold"], dtype=tdt, device=dev)
            it = int(extra["it"])
        else:
            x, r, p, rs = program_cache.cached_program(
                "cg_init", key, lambda: _cg_init, comm=comm, inline=True)(
                matvec, b._global().to(tdt), x0._global().to(tdt))
            it = 0
        window = program_cache.cached_program("cg_chunk", key, lambda: _cg_window, comm=comm,
                                              inline=True)
        while it < n:
            start = it
            x, r, p, rs, it = window(matvec, x, r, p, rs, it, min(it + every, n))
            if it == start:
                break  # converged: a window that made no progress
            _save_carry(checkpoint_path, (x, r, p),
                        {"algo": "cg", "it": it, "rsold": float(rs)}, comm)
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
    key = _kind_key(A, n, tdt) + (m,)
    comm = A.comm
    if every is None:
        basis, alphas, betas = program_cache.cached_program(
            "lanczos", key, lambda: _lanczos_solve, comm=comm, inline=True)(matvec, v, m, eps)
    else:
        loaded = _load_carry(checkpoint_path, "lanczos", 4, comm, resume)
        if loaded is not None:
            leaves, extra = loaded
            basis, alphas, betas, w = (torch.as_tensor(np.asarray(t)).to(dev, tdt)
                                       for t in leaves)
            first = int(extra["i"])
        else:
            basis, alphas, betas, w = program_cache.cached_program(
                "lanczos_init", key, lambda: _lanczos_init, comm=comm, inline=True)(
                matvec, v, m)
            first = 1
        window = program_cache.cached_program("lanczos_chunk", key, lambda: _lanczos_window,
                                              comm=comm, inline=True)
        for lo in range(first, m, every):
            hi = min(lo + every, m)
            w = window(matvec, basis, alphas, betas, w, lo, hi, eps)
            _save_carry(checkpoint_path, (basis, alphas, betas, w), {"algo": "lanczos", "i": hi},
                        comm)
    T = torch.diag(alphas) + torch.diag(betas[1:], 1) + torch.diag(betas[1:], -1)
    V = _from_global(basis.t().contiguous(), A.split, A.device, A.comm, dt)
    T = _from_global(T, None, A.device, A.comm, dt)
    if V_out is not None:
        V_out.larray, T_out.larray = V.larray, T.larray
        return V_out, T_out
    return V, T
