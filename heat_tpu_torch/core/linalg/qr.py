"""Distributed QR decomposition (counterpart of
``heat_tpu/core/linalg/qr.py``), on per-rank chunks over
``torch.distributed``; the factorizations themselves are ``torch.linalg``
(cuSOLVER on the card), as the JAX package's are XLA's.

* **TSQR** (split 0, several ranks, m ≥ n): a local QR of each chunk
  (``tiles_per_proc`` panels deep), the R factors of height
  ``k1 = min(ceil(m/p), n)`` gathered to every rank, a replicated QR of the
  stack, and one local product for Q. A chunk shorter than ``k1`` (or
  empty) pads its R factor with zero rows: ``QR([A; 0]) = ([Q; 0], R)``,
  so the stack is the JAX package's, whose physical buffer holds those
  zero rows.
* **CholeskyQR2** (split 1, m ≥ n): the Gram matrix ``G = AᵀA`` over a ring
  of ``ring_permute`` hops (each rank keeps its block and the blocks
  circulate), a replicated Cholesky, and the panel solve ``Q = A·R⁻¹``
  whose partials a ``reduce_scatter`` sums into column chunks; a second
  pass restores orthogonality. If a Cholesky breaks down, a shifted
  Cholesky and one extra pass take over. The ring has the JAX package's two
  schedules, with bit-identical tiles: ``HEAT_TPU_RING_OVERLAP`` on (the
  default) issues each hop before the tile product and waits after it,
  p − 1 hops; off, p hops one after the other. The knob is read from
  ``os.environ`` at call time.
* **wide** (m < n, split 0 or 1): the m × m leading block is gathered (the
  only replicated piece), its Q computed on every rank, and ``R = QᵀA``.
* **general** (one rank, or a replicated input): one ``torch.linalg.qr``.

The matrix is never gathered whole on a distributed path.

Telemetry: TSQR is a ``tsqr`` span and each Gram ring a
``cholqr_gram_ring`` span, with the analytic wire bytes of
``telemetry.collectives.tsqr_cost`` and ``gram_ring_cost`` (with the hops
the ring makes); ``audit=True`` (or ``HEAT_TPU_HLO_AUDIT=1``) records their
collectives and compares them with those costs (``telemetry.hlo``).
"""

from __future__ import annotations

import collections

import torch

from ... import telemetry
from .. import program_cache, types
from ..communication import _padded, ring_steps
from ..relayout_planner import ring_overlap
from ..dndarray import DNDarray
from .basics import _from_global, _replicated, matmul

__all__ = ["qr"]

QR = collections.namedtuple("QR", "Q, R")


def _gram_ring(loc: torch.Tensor, comm, n: int) -> torch.Tensor:
    """``G = AᵀA`` (n × n, on every rank) of a column-split ``A`` whose chunk
    on this rank is ``loc`` (m × its columns). Each rank keeps its block
    (padded to ``c = ceil(n/p)`` columns) and the blocks circulate; step t
    computes the tile ``G[my columns, origin's columns]``."""
    p, c = comm.size, comm.chunk_size(n)
    xt = _padded(loc, 1, c).t().contiguous()  # (c, m)
    acc = xt.new_zeros((c, c * p))

    def tile_into(t, origin, circ):
        acc[:, origin * c:(origin + 1) * c] = xt @ circ.t()

    overlap = ring_overlap()
    ring_steps(comm, xt, tile_into, overlap=overlap, home=not overlap)
    return comm.allgather(acc[:loc.shape[1]], 0, n)[:, :n]


def _cholqr_split1(a: DNDarray, dt, calc_q: bool, audit: bool = False) -> QR:
    """CholeskyQR2 with the shifted-Cholesky fallback (module docstring)."""
    comm = a.comm
    m, n = a.shape
    q_loc = a.larray.to(dt.torch_type())  # (m, this rank's columns)
    eye = torch.eye(n, dtype=q_loc.dtype, device=q_loc.device)
    eps = torch.finfo(q_loc.dtype).eps
    r_factors = []
    passes_left, shifted = 2, False
    gram_hops = comm.size - 1 if ring_overlap() else comm.size
    while passes_left > 0:
        cost, fields, do_audit = telemetry.op_cost(
            telemetry.collectives.gram_ring_cost, m, n, dt.byte_size(), comm.size, gram_hops,
            audit=audit)
        with telemetry.span("cholqr_gram_ring", gshape=[m, n], overlap=gram_hops < comm.size,
                            **fields) as sp:
            gram = program_cache.cached_program(
                "cholqr_gram_ring", ((m, n), str(q_loc.dtype), gram_hops < comm.size),
                lambda: _gram_ring, comm=comm, inline=True)
            if do_audit:
                g, _ = telemetry.hlo.audit_call(
                    "cholqr_gram_ring", lambda: gram(q_loc, comm, n), predicted=cost,
                    fields={"gshape": [m, n], "mesh": comm.size})
            else:
                g = gram(q_loc, comm, n)
            sp.output(g)
        ell, info = torch.linalg.cholesky_ex(g)
        # breakdown on this pass: a failed factorization, NaNs or a collapsed
        # diagonal mean G is (numerically) singular
        diag = torch.diagonal(ell).abs()
        if int(info) != 0 or bool(torch.isnan(ell).any()) or \
                float(diag.min()) <= n * eps * max(float(diag.max()), 1.0):
            shift = 11.0 * eps * (m * n + n * (n + 1)) * torch.trace(g)
            ell = torch.linalg.cholesky(g + shift * eye)
            if not shifted:
                shifted = True
                passes_left += 1
        rinv = torch.linalg.solve_triangular(ell, eye, upper=False).t()  # R = Lᵀ
        q_loc = program_cache.cached_program("cholqr_panel_solve", (), lambda: _panel_solve,
                                             comm=comm, inline=True)(q_loc, rinv, comm, n)
        r_factors.append(ell.t())
        passes_left -= 1
    r_log = r_factors[0]
    for f in r_factors[1:]:
        r_log = f @ r_log
    r_ht = _from_global(r_log, 1, a, dt)
    if not calc_q:
        return QR(None, r_ht)
    return QR(DNDarray(q_loc.contiguous(), (m, n), dt, 1, a.device, comm, True), r_ht)


def _panel_solve(q_loc: torch.Tensor, rinv: torch.Tensor, comm, n: int) -> torch.Tensor:
    """``Q = A R⁻¹`` of a column-split ``A`` (this rank's columns
    ``q_loc``): each rank's partial product over its rows of ``R⁻¹``, then
    one reduce-scatter along the columns (site ``cholqr_panel_solve``)."""
    counts, displs = comm.counts_displs(n)
    start, count = displs[comm.rank], counts[comm.rank]
    partial = q_loc @ rinv[start:start + count]  # (m, n)
    return comm.reduce_scatter(partial, 1, n)


def _gather_leading_columns(loc: torch.Tensor, comm, n: int, m: int) -> torch.Tensor:
    """The first ``m`` columns of a column-split array of ``n`` columns, on
    every rank: each rank sends only its part of them."""
    counts, displs = comm.counts_displs(n)
    k = min(comm.chunk_size(n), m)
    lens = [max(0, min(d + c, m) - d) for c, d in zip(counts, displs)]
    piece = _padded(loc[:, :lens[comm.rank]], 1, k)
    parts = comm.allgather(piece, 1, k * comm.size).split(k, dim=1)
    return torch.cat([part[:, :ln] for part, ln in zip(parts, lens)], dim=1)


def _wide_split1(a: DNDarray, dt, calc_q: bool) -> QR:
    """Reduced QR of a wide (m < n) column-split matrix: its Q is the Q of
    the leading m × m block, and ``R = QᵀA`` is a local product that keeps
    split 1."""
    m, n = a.shape
    buf = a.larray.to(dt.torch_type())
    lead = program_cache.cached_program("qr_wide_lead", (m,), lambda: _gather_leading_columns,
                                        comm=a.comm, inline=True)(buf, a.comm, n, m)
    q_log, _ = torch.linalg.qr(lead)
    r_ht = DNDarray(q_log.t() @ buf, (m, n), dt, 1, a.device, a.comm, True)
    if not calc_q:
        return QR(None, r_ht)
    return QR(_from_global(q_log, 1, a, dt), r_ht)


def _local_tsqr(x: torch.Tensor, tiles: int):
    """QR of a rank's chunk, blocked into ``tiles`` row panels (the QR of
    each, then of their stacked R factors); one QR when the panels would be
    wider than tall."""
    c, n = x.shape
    if tiles <= 1 or c % tiles != 0 or c // tiles < n:
        return torch.linalg.qr(x)
    cb = c // tiles
    q1, r1 = torch.linalg.qr(x.reshape(tiles, cb, n))  # (t, cb, n), (t, n, n)
    q2, r = torch.linalg.qr(r1.reshape(tiles * n, n))
    q = torch.bmm(q1, q2.reshape(tiles, n, n)).reshape(c, n)
    return q, r


def _tsqr(a: DNDarray, dt, tiles_per_proc: int, calc_q: bool, audit: bool = False) -> QR:
    """TSQR of a tall row-split matrix (module docstring)."""
    comm = a.comm
    m, n = a.shape
    cost, fields, do_audit = telemetry.op_cost(
        telemetry.collectives.tsqr_cost, m, n, dt.byte_size(), comm.size, audit=audit)
    body = program_cache.cached_program("tsqr", ((m, n), dt, tiles_per_proc, calc_q),
                                        lambda: _tsqr_body, comm=comm, inline=True)
    with telemetry.span("tsqr", gshape=[m, n], mesh=comm.size, **fields) as sp:
        if do_audit:
            out, _ = telemetry.hlo.audit_call(
                "tsqr", lambda: body(a, dt, tiles_per_proc, calc_q), predicted=cost,
                fields={"gshape": [m, n], "mesh": comm.size})
        else:
            out = body(a, dt, tiles_per_proc, calc_q)
        sp.output(out.R.larray)
    return out


def _tsqr_body(a: DNDarray, dt, tiles_per_proc: int, calc_q: bool) -> QR:
    comm = a.comm
    m, n = a.shape
    buf = a.larray.to(dt.torch_type())
    k1 = min(comm.chunk_size(m), n)
    if buf.shape[0] == 0:
        q1, r1 = buf.new_zeros((0, 0)), buf.new_zeros((0, n))
    else:
        q1, r1 = _local_tsqr(buf, tiles_per_proc)  # (count, kc), (kc, n), kc = min(count, n)
    stacked = comm.allgather(_padded(r1, 0, k1), 0, k1 * comm.size)  # (p k1, n)
    q2, r = torch.linalg.qr(stacked)  # (p k1, n), (n, n): p k1 >= n
    r_ht = _replicated(r, a, dt)
    if not calc_q:
        return QR(None, r_ht)
    q_loc = q1 @ q2[comm.rank * k1:comm.rank * k1 + q1.shape[1]]
    return QR(DNDarray(q_loc, (m, n), dt, 0, a.device, comm, True), r_ht)


def qr(
    a: DNDarray,
    tiles_per_proc: int = 1,
    calc_q: bool = True,
    overwrite_a: bool = False,
    audit: bool = False,
) -> QR:
    """Reduced QR factorization ``a = Q @ R`` (reference qr.py:17), with the
    JAX package's splits of Q and R:

    ===========  =======================  =====================  =======  =======
    path         when                     how                    Q split  R split
    ===========  =======================  =====================  =======  =======
    TSQR         split 0, p > 1, m ≥ n    module docstring       0        None
    CholeskyQR2  split 1, p > 1, m ≥ n    module docstring       1        1
    wide         split 1, p > 1, m < n    leading block, QᵀA     1        1
    wide         split 0, p > 1, m < n    leading block, matmul  0        0
    general      p = 1 or split None      ``torch.linalg.qr``    a's      None (1
                                                                          for
                                                                          split 1)
    ===========  =======================  =====================  =======  =======

    Column signs of Q and R are not unique: compare ``Q @ R`` and
    ``Q.T @ Q``. ``overwrite_a`` is accepted as the JAX package accepts it
    (``a`` is never written). ``audit=True`` audits the collectives of TSQR
    and of the Gram rings (module docstring); the other paths are not
    audited, as in the JAX package."""
    if not isinstance(a, DNDarray):
        raise TypeError(f"'a' must be a DNDarray, but was {type(a)}")
    if a.ndim != 2:
        raise ValueError(f"'a' must be 2-dimensional, but has {a.ndim} dimensions")
    if not isinstance(tiles_per_proc, int):
        raise TypeError(f"tiles_per_proc must be an int, but was {type(tiles_per_proc)}")

    m, n = a.shape
    comm = a.comm
    dt = types.promote_types(a.dtype, types.float32)
    if comm.size > 1 and a.split == 0:
        if m >= n:
            return _tsqr(a, dt, tiles_per_proc, calc_q, audit)
        # wide: Q of the leading m × m block, then R = QᵀA, a contraction over
        # the split rows (reduce_scatter in matmul, split 0)
        lead = comm.allgather(a.larray[:, :m].to(dt.torch_type()), 0, m)
        q_log, _ = torch.linalg.qr(lead)
        r_ht = matmul(_replicated(q_log.t().contiguous(), a, dt), a)
        if not calc_q:
            return QR(None, r_ht)
        return QR(_from_global(q_log, 0, a, dt), r_ht)
    if comm.size > 1 and a.split == 1:
        if m >= n:
            return _cholqr_split1(a, dt, calc_q, audit)
        return _wide_split1(a, dt, calc_q)

    q_log, r_log = torch.linalg.qr(a.larray.to(dt.torch_type()))
    r_ht = _from_global(r_log, 1 if a.split == 1 else None, a, dt)
    if not calc_q:
        return QR(None, r_ht)
    return QR(_from_global(q_log, a.split, a, dt), r_ht)
