"""Pairwise distance computations (counterpart of
``heat_tpu/spatial/distance.py``: ``cdist``, ``rbf`` and ``manhattan``).

The result is (n_x, n_y), distributed along the rows of x; y is replicated
on every rank first (``resplit(None)``, the JAX package's
``distance.py:315``). With ``quadratic_expansion=True`` and inside the
kernel's gate (f32, k <= 512, one rank or x split along its rows) every
rank computes its row slab with the cdist kernel, whose epilogue gives
distances or, for ``rbf``, the Gaussian kernel directly (``:317-344``
there). Otherwise the GEMM form or the broadcast form runs in plain torch;
``manhattan`` is always the broadcast form, as in the JAX package. A kernel
failure raises; nothing falls back.

``ring=True`` with both operands split along their rows over more than one
rank runs the ring schedule (``_ring_dist`` :101): each rank keeps its rows
of x and the row blocks of y circulate (``ring_permute``), so no rank holds
all of y. By default the next hop is issued before the tile's product and
the last hop, which would only bring every block home, is not made (``p - 1``
hops); ``HEAT_TPU_RING_OVERLAP=0`` (or ``false``, ``off``, ``no``) takes the
serial schedule of ``p`` hops. The tiles are the same either way. A tile is
the JAX package's block function in plain torch (the GEMM form or the
broadcast form), as the JAX package's ring runs no Pallas kernel. Off that
gate ``ring=True`` takes the ordinary path.

Every call (``cdist``, ``rbf``, ``manhattan``) is a ``cdist`` telemetry span
from its entry to its result, with the gather of y (a ``resplit`` span) and
the kernel (``pallas_cdist``) inside it. The ring is a ``ring_cdist`` span
inside it too, with the analytic wire bytes
(``telemetry.collectives.ring_cdist_cost`` with the hops it makes, ``p - 1``
or ``p``); ``audit=True`` (or ``HEAT_TPU_HLO_AUDIT=1``) records its hops and
compares them with that cost (``telemetry.hlo``). The other paths issue at
most the gather of y and are not audited, as in the JAX package.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .. import telemetry
from ..core import program_cache, types
from ..core.communication import ring_steps
from ..core.relayout_planner import ring_overlap
from ..core.dndarray import DNDarray

__all__ = ["cdist", "manhattan", "rbf"]

_BLOCK_BUDGET = 1 << 28  # bytes of the broadcast form's (rows, n, k) temporary


def _blocked(x: torch.Tensor, y: torch.Tensor, manhattan: bool = False) -> torch.Tensor:
    """The broadcast form of the euclidean (or city-block) distance over row
    blocks of x, so that the (rows, n, k) temporary stays under 256 MiB (the
    JAX package's ``_blocked_rows`` :56)."""
    m, k = x.shape
    n = y.shape[0]
    per_row = max(1, n * k * x.element_size())
    bs = max(1, min(m, _BLOCK_BUDGET // per_row))
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    for s in range(0, m, bs):
        diff = x[s:s + bs, None, :] - y[None, :, :]
        out[s:s + bs] = diff.abs().sum(dim=-1) if manhattan else torch.sqrt((diff * diff).sum(dim=-1))
    return out


def _ring_dist(xb: torch.Tensor, yb: torch.Tensor, n: int, comm,
               tile_fn: Callable) -> torch.Tensor:
    """This rank's rows of the (m, n) distance matrix of row-split x and y:
    the y blocks (each padded to the chunk length ``c``) circulate around
    the ring, and after ``t`` hops this rank holds the block of rank
    ``rank - t``, whose tile fills columns ``[origin * c, origin * c + c)``."""
    p, c = comm.size, comm.chunk_size(n)
    if yb.shape[0] < c:
        yb = torch.cat([yb, yb.new_zeros((c - yb.shape[0], yb.shape[1]))])
    out = xb.new_empty((xb.shape[0], c * p))

    def tile_into(t, origin, yblk):
        out[:, origin * c:origin * c + c] = tile_fn(xb, yblk)

    overlap = ring_overlap()
    ring_steps(comm, yb, tile_into, overlap=overlap, home=not overlap)
    return out[:, :n]


def _dist(x: DNDarray, y: Optional[DNDarray], quadratic: bool,
          rbf_gamma: Optional[float] = None, manhattan: bool = False,
          ring: bool = False, audit: bool = False) -> DNDarray:
    from .cuda_cdist import euclid, euclid_plain, pallas_cdist_applicable

    with telemetry.span("cdist"):
        if not isinstance(x, DNDarray):
            raise TypeError(f"x must be a DNDarray, but was {type(x)}")
        if x.ndim != 2:
            raise NotImplementedError(f"x has {x.ndim} dimensions, expecting 2")
        if y is None:
            y = x
        if not isinstance(y, DNDarray):
            raise TypeError(f"y must be a DNDarray, but was {type(y)}")
        if y.ndim != 2:
            raise NotImplementedError(f"y has {y.ndim} dimensions, expecting 2")
        if x.shape[1] != y.shape[1]:
            raise ValueError(
                f"inputs must have the same number of features, got {x.shape[1]} and {y.shape[1]}"
            )
        if x.split is not None and x.split != 0:
            raise NotImplementedError("cdist requires x.split in (None, 0)")

        promoted = types.promote_types(types.promote_types(x.dtype, y.dtype), types.float32)
        tdt = promoted.torch_type()
        out_split = 0 if x.split == 0 else None
        m, n = x.shape[0], y.shape[0]
        xb = x.larray.to(tdt)
        if ring and x.split == 0 and y.split == 0 and x.comm.size > 1:
            if quadratic:
                tile = lambda a, b: euclid_plain(a, b, epilogue="dist", precision="HIGHEST")  # noqa: E731
            else:
                tile = lambda a, b: _blocked(a, b, manhattan)  # noqa: E731
            p = x.comm.size
            hops = p - 1 if ring_overlap() else p
            cost, fields, do_audit = telemetry.op_cost(
                telemetry.collectives.ring_cdist_cost, n, x.shape[1], promoted.byte_size(), p,
                hops, audit=audit)
            with telemetry.span("ring_cdist", gshape=[m, n], mesh=p, overlap=hops < p,
                                **fields):
                kind = "quadratic" if quadratic else ("manhattan" if manhattan else "euclid")
                ring = program_cache.cached_program(
                    "ring_cdist", (kind, x.shape[1], str(tdt), hops < p), lambda: _ring_dist,
                    comm=x.comm, inline=True)
                run = lambda: ring(xb, y.larray.to(tdt), n, x.comm, tile)  # noqa: E731
                if do_audit:
                    out, _ = telemetry.hlo.audit_call("ring_cdist", run, predicted=cost,
                                                      fields={"mesh": p})
                else:
                    out = run()
            if rbf_gamma is not None:
                out = torch.exp(-rbf_gamma * out * out)
            return DNDarray(out, (m, n), promoted, out_split, x.device, x.comm, True)
        yb = (y.resplit(None).larray if y.split is not None else y.larray).to(tdt)

        if quadratic:
            # the kernel where the JAX package takes its Pallas kernel (one rank
            # or x split along its rows, inside the gate), else its plain version
            layout_ok = x.comm.size == 1 or x.split == 0
            fn = euclid if layout_ok and pallas_cdist_applicable(x.shape[1], tdt) else euclid_plain
            epi = "rbf" if rbf_gamma is not None else "dist"
            out = fn(xb, yb, 0.0 if rbf_gamma is None else float(rbf_gamma), epilogue=epi)
        else:
            out = _blocked(xb, yb, manhattan)
            if rbf_gamma is not None:
                out = torch.exp(-rbf_gamma * out * out)
        return DNDarray(out, (m, n), promoted, out_split, x.device, x.comm, True)


def cdist(X: DNDarray, Y: Optional[DNDarray] = None, quadratic_expansion: bool = False,
          ring: bool = False, audit: bool = False) -> DNDarray:
    """Euclidean distance matrix (reference distance.py:136).
    ``quadratic_expansion`` selects the GEMM form, which the cdist kernel
    computes on the card; ``ring=True`` takes the ring schedule when both
    operands are split along their rows over several ranks, and
    ``audit=True`` audits the ring's collectives (module docstring)."""
    return _dist(X, Y, quadratic_expansion, ring=ring, audit=audit)


def rbf(X: DNDarray, Y: Optional[DNDarray] = None, sigma: float = 1.0,
        quadratic_expansion: bool = False, ring: bool = False, audit: bool = False) -> DNDarray:
    """Gaussian kernel matrix exp(-|x-y|^2 / 2 sigma^2) (reference
    distance.py:159). With the GEMM form on the card the exp is the
    kernel's epilogue; after the ring it is one pass over the result."""
    gamma = 1.0 / (2.0 * sigma * sigma)
    return _dist(X, Y, quadratic_expansion, rbf_gamma=gamma, ring=ring, audit=audit)


def manhattan(X: DNDarray, Y: Optional[DNDarray] = None, expand: bool = False,
              ring: bool = False, audit: bool = False) -> DNDarray:
    """City-block distance matrix (reference distance.py:363), in the
    broadcast form. ``expand`` is accepted for parity and changes nothing,
    as in the JAX package; ``ring=True`` and ``audit`` as for :func:`cdist`."""
    return _dist(X, Y, False, manhattan=True, ring=ring, audit=audit)
