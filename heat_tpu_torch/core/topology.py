"""The 2-level (node x local) topology and the tiered collectives
(counterpart of ``heat_tpu/core/topology.py``).

* :class:`Topology` — a ``(node, local)`` factorization of the ``p`` ranks:
  rank ``i`` sits at ``(i // local, i % local)``, node-major, as DASO's
  split. ``HEAT_TPU_TOPOLOGY=NODExLOCAL`` (``2x4``) declares it; unset,
  :func:`detect` takes one node a host when the ranks span several hosts,
  the emulated two-node split on one host with an even world (as the JAX
  package does on one host), else the trivial ``1 x p``.
* The tiered lowerings that :class:`~.communication.TorchCommunication`
  dispatches to under ``HEAT_TPU_HIERARCHICAL=1``: :func:`hier_psum`
  (in-node reduce-scatter, cross-node all-reduce of the ``1/local`` shard,
  in-node all-gather), :func:`hier_reduce_scatter`, :func:`hier_all_gather`
  and :func:`hier_all_to_all`. The in-node tier moves exact; the cross-node
  tier at ``cross_wire`` (:func:`cross_mode`). The JAX package runs them in
  ``shard_map`` with ``axis_index_groups``; here the groups are
  ``torch.distributed`` groups, the in-node and the cross communicators of
  :meth:`TorchCommunication.tiers`, made once for each communicator by
  every rank in the same order.
* :func:`node_mean_cross_sum` — DASO's send: the mean over the node, then
  the sum across the nodes in reduced precision.

Degenerate topologies (``1 x N``, ``N x 1``) lower flat; with
``HEAT_TPU_HIERARCHICAL=0`` (the default) nothing here runs.
"""

from __future__ import annotations

import socket
import warnings
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch

from .. import _knobs as knobs

__all__ = [
    "Topology",
    "active",
    "cache_token",
    "cross_mode",
    "detect",
    "fsdp_wire",
    "hier_all_gather",
    "hier_all_to_all",
    "hier_exchange",
    "hier_psum",
    "hier_reduce_scatter",
    "hierarchical_requested",
    "node_mean_cross_sum",
    "parse",
    "resolve",
]

_ENV_TOPO = "HEAT_TPU_TOPOLOGY"
_ENV_HIER = "HEAT_TPU_HIERARCHICAL"
_ENV_PREC = "HEAT_TPU_HIERARCHICAL_PREC"


@dataclass(frozen=True)
class Topology:
    """A 2-level factorization of ``p`` ranks: ``node`` the slow tier's
    size, ``local`` the fast tier's; ``source`` is ``"knob"``,
    ``"detected"`` or ``"trivial"``."""

    node: int
    local: int
    source: str = "detected"

    @property
    def size(self) -> int:
        return self.node * self.local

    @property
    def nontrivial(self) -> bool:
        """Whether the tiered lowering differs from the flat one."""
        return self.node > 1 and self.local > 1

    def node_groups(self) -> List[List[int]]:
        """The in-node groups: ``local`` consecutive ranks a node."""
        return [[n * self.local + i for i in range(self.local)] for n in range(self.node)]

    def cross_groups(self) -> List[List[int]]:
        """The cross-node groups: one a place in the node, striding the nodes."""
        return [[n * self.local + i for n in range(self.node)] for i in range(self.local)]

    def describe(self) -> str:
        return f"{self.node}x{self.local}"


def parse(raw: str, p: int) -> Optional[Topology]:
    """The ``HEAT_TPU_TOPOLOGY`` grammar (``NODExLOCAL``, ``x`` or ``×``)
    against ``p`` ranks; None for a malformed value, and with a warning
    for one that does not multiply to ``p``."""
    s = (raw or "").strip().lower().replace("×", "x")
    if not s:
        return None
    parts = s.split("x")
    if len(parts) != 2:
        return None
    try:
        node, local = int(parts[0]), int(parts[1])
    except ValueError:
        return None
    if node <= 0 or local <= 0:
        return None
    if node * local != p:
        warnings.warn(
            f"HEAT_TPU_TOPOLOGY={raw!r} declares {node}x{local}={node * local} positions but "
            f"the world has {p}; falling back to auto-detection")
        return None
    return Topology(node, local, source="knob")


def _host_count(comm) -> int:
    """The hosts ``comm``'s ranks run on (one exchange of host names,
    made once for each communicator)."""
    if comm is None or comm.size <= 1:
        return 1
    if comm._hosts is None:
        comm._hosts = len(set(comm.allgather_object(socket.gethostname())))
    return comm._hosts


def detect(p: int, comm=None, hosts: Optional[int] = None) -> Topology:
    """A factorization of ``p`` ranks: one node a host when the ranks span
    several hosts (``hosts``, else counted over ``comm``) and the host
    count divides ``p`` (the JAX package counts its processes); the
    two-node split of an even world on one host; else ``1 x p``."""
    if hosts is None:
        hosts = _host_count(comm)
    if hosts > 1 and p % hosts == 0:
        return Topology(hosts, p // hosts, source="detected")
    if p > 1 and p % 2 == 0:
        return Topology(2, p // 2, source="detected")
    return Topology(1, p, source="trivial")


def resolve(p: int, comm=None) -> Topology:
    """The knob when set and valid, else :func:`detect`."""
    topo = parse(knobs.raw(_ENV_TOPO, "") or "", p)
    return topo if topo is not None else detect(p, comm)


def hierarchical_requested() -> bool:
    """The ``HEAT_TPU_HIERARCHICAL`` bit (default off)."""
    return bool(knobs.get(_ENV_HIER))


def active(p: int, comm=None) -> Optional[Topology]:
    """The topology to lower tiered against, or None for the flat path:
    ``HEAT_TPU_HIERARCHICAL=1`` and a nontrivial factorization."""
    if not hierarchical_requested():
        return None
    topo = resolve(p, comm)
    return topo if topo.nontrivial else None


def cross_mode(dtype, precision: Optional[str] = None) -> str:
    """The cross-node tier's wire for one payload: ``precision``, else
    ``HEAT_TPU_HIERARCHICAL_PREC`` when set, else
    ``HEAT_TPU_COLLECTIVE_PREC``; ``off`` for a non-float type."""
    from . import collective_prec

    if precision is None:
        raw = (knobs.raw(_ENV_PREC, "") or "").strip().lower()
        if raw in collective_prec.MODES:
            precision = raw
    return collective_prec.effective(dtype, precision)


def fsdp_wire(dtype, p: int, precision: Optional[str] = None, comm=None) -> str:
    """The wire of one FSDP weight gather and its reduce-scatter:
    ``precision``, else ``HEAT_TPU_FSDP_PREC``, else the cross-node chain
    under an active topology, else ``off`` (a compressed weight gather
    changes the model every step, so the flat default is exact)."""
    from . import collective_prec

    if precision is None:
        raw = (knobs.raw("HEAT_TPU_FSDP_PREC", "") or "").strip().lower()
        if raw in collective_prec.MODES:
            precision = raw
    if precision is None:
        if active(p, comm) is not None:
            return cross_mode(dtype, None)
        return "off"
    return collective_prec.effective(dtype, precision)


def cache_token(p: int, comm=None) -> Tuple:
    """``("flat",)``, or ``("hier", node, local, cross-tier knob)``: the
    tiered-lowering state a cached program depends on."""
    topo = active(p, comm)
    if topo is None:
        return ("flat",)
    return ("hier", topo.node, topo.local, (knobs.raw(_ENV_PREC, "") or "").strip().lower())


# -- the tiered lowerings ----------------------------------------------------------


def _pad_flat(x: torch.Tensor, multiple: int) -> Tuple[torch.Tensor, int]:
    n = x.numel()
    n_pad = -(-n // multiple) * multiple
    flat = x.reshape(-1)
    if n_pad != n:
        flat = torch.nn.functional.pad(flat, (0, n_pad - n))
    return flat, n


def hier_psum(x: torch.Tensor, comm, topo: Topology, cross_wire: str = "off",
              block: Optional[int] = None) -> torch.Tensor:
    """Tiered sum, out of place: in-node reduce-scatter (exact), cross-node
    all-reduce of the ``1/local`` shard at ``cross_wire``, in-node
    all-gather. Equal to the flat sum where the sums are exact; otherwise
    it differs only by the order of the additions."""
    from . import collective_prec as cp

    in_node, cross = comm.tiers(topo)
    flat, n = _pad_flat(x, topo.local)
    s = in_node.sum_scatter(flat)
    s = cp.psum(s, cross, cross_wire if cp.compressible(x.dtype) else "off", block)
    return in_node.gather_stack(s).reshape(-1)[:n].reshape(x.shape)


def hier_reduce_scatter(x: torch.Tensor, comm, topo: Topology, cross_wire: str = "off",
                        block: Optional[int] = None) -> torch.Tensor:
    """Tiered reduce-scatter to the flat ``1/p`` chunk: in-node
    reduce-scatter (exact) to the ``1/local`` shard, then cross-node
    reduce-scatter of it at ``cross_wire``. Returns this rank's 1-D
    ``(ceil(numel/p),)`` chunk, as the flat ``reduce_scatter_flat``."""
    from . import collective_prec as cp

    in_node, cross = comm.tiers(topo)
    flat, _ = _pad_flat(x, topo.size)
    c = flat.numel() // topo.size
    # chunks arranged (local, node)-major so that stage two hands rank
    # (n, l) the flat chunk n * local + l
    arranged = flat.reshape(topo.node, topo.local, c).transpose(0, 1).reshape(-1)
    s = in_node.sum_scatter(arranged)
    return cp.reduce_scatter(s, cross, cross_wire, block)


def _two_stage_gather(comm, topo: Topology):
    """The exact two-stage gather: cross-node first, then in-node,
    reordered to the flat gather's node-major source order."""
    in_node, cross = comm.tiers(topo)

    def mover(u: torch.Tensor) -> torch.Tensor:
        g2 = in_node.gather_stack(cross.gather_stack(u))      # (local, node) + u.shape
        return g2.transpose(0, 1).reshape((topo.size,) + tuple(u.shape))

    return mover


def hier_all_gather(x: torch.Tensor, comm, topo: Topology, cross_wire: str = "off",
                    block: Optional[int] = None, tiled: bool = True) -> torch.Tensor:
    """Tiered all-gather: the cross-node gather of this rank's ``x``, then
    the in-node gather of the stacked node blocks. Exact mode is bit for
    bit the flat gather; a compressed mode quantizes once at the source and
    moves payload and scales through both stages."""
    from . import collective_prec as cp

    mover = _two_stage_gather(comm, topo)
    p = topo.size
    if cross_wire == "off" or not cp.compressible(x.dtype):
        g = mover(x)
    elif cross_wire == "bf16":
        g = mover(x.to(torch.bfloat16)).to(x.dtype)
    elif cross_wire == "int8":
        q, s = cp._quant_tensor(x)
        g = cp._deq(mover(q), mover(s).reshape((p,) + (1,) * x.dim())).to(x.dtype)
    else:
        q, s = cp._quant_flat_blocks(x, block or cp.block_size())
        g = cp._deq(mover(q), mover(s)[..., None]).reshape(p, -1)[:, :x.numel()]
        g = g.reshape((p,) + tuple(x.shape)).to(x.dtype)
    if tiled and x.dim() >= 1:
        return g.reshape((p * x.shape[0],) + tuple(x.shape[1:]))
    return g


def _two_stage_exchange(comm, topo: Topology):
    """The exact two-stage slab exchange: stage A swaps destination-local
    slabs inside each node, stage B destination-node bundles across the
    nodes. Input: ``p`` destination slabs (node-major) along dimension 0;
    output: the ``p`` source slabs (node-major), the flat exchange's
    contract."""
    in_node, cross = comm.tiers(topo)

    def mover(slabs: torch.Tensor) -> torch.Tensor:
        b = slabs.reshape((topo.node, topo.local) + tuple(slabs.shape[1:]))
        a = in_node.exchange(b.transpose(0, 1).contiguous())     # (src_local, node, ...)
        c = cross.exchange(a.transpose(0, 1).contiguous())       # (src_node, src_local, ...)
        return c.reshape(slabs.shape)

    return mover


def hier_exchange(slabs: torch.Tensor, comm, topo: Topology, cross_wire: str = "off",
                  block: Optional[int] = None) -> torch.Tensor:
    """Tiered all-to-all of equal slabs (``comm.exchange``'s contract).
    Exact mode is bit for bit the flat exchange; a compressed mode
    quantizes each destination slab at the source and moves payload and
    scales through both stages."""
    from . import collective_prec as cp

    mover = _two_stage_exchange(comm, topo)
    if cross_wire == "off" or not cp.compressible(slabs.dtype):
        return mover(slabs)
    if cross_wire == "bf16":
        return mover(slabs.to(torch.bfloat16)).to(slabs.dtype)
    p = slabs.shape[0]
    m = slabs[0].numel()
    flat = slabs.reshape(p, m).float()
    if cross_wire == "int8":
        nb, seg = 1, m
    else:
        seg = max(1, min(block or cp.block_size(), m))
        nb = max(1, -(-m // seg))
        if nb * seg != m:
            flat = torch.nn.functional.pad(flat, (0, nb * seg - m))
    b3 = flat.reshape(p, nb, seg)
    s = cp._scale_of(b3.abs().amax(dim=2))
    qt, st = mover(cp._round_q(b3, s[..., None])), mover(s)
    deq = cp._deq(qt, st[..., None]).reshape(p, -1)[:, :m]
    return deq.reshape(slabs.shape).to(slabs.dtype)


def hier_all_to_all(x: torch.Tensor, comm, topo: Topology, split_axis: int, concat_axis: int,
                    cross_wire: str = "off", block: Optional[int] = None) -> torch.Tensor:
    """Tiered tiled all-to-all (``lax.all_to_all(tiled=True)``'s contract,
    as :func:`.collective_prec.all_to_all`)."""
    p = topo.size
    xm = x.movedim(split_axis, 0)
    w = xm.shape[0] // p
    slabs = xm.reshape((p, w) + tuple(xm.shape[1:])).contiguous()
    out = hier_exchange(slabs, comm, topo, cross_wire, block)
    out = out.movedim(1, 1 + split_axis).movedim(0, concat_axis)
    shp = list(out.shape)
    shp[concat_axis:concat_axis + 2] = [shp[concat_axis] * shp[concat_axis + 1]]
    return out.reshape(shp)


# -- DASO's tier primitive ------------------------------------------------------------


def node_mean_cross_sum(x: torch.Tensor, *, local_comm, node_comm, wire: str,
                        cast_dtype=torch.bfloat16, block: Optional[int] = None) -> torch.Tensor:
    """DASO's send: the node representative is the mean over ``local_comm``
    (the fast tier), then the SUM across ``node_comm`` (the slow tier), not
    the mean: DASO folds the node count into its merge. ``off`` moves
    ``cast_dtype`` on the wire, ``bf16`` pins bf16, ``int8``/``blockwise``
    run the two-phase quantized sum and return f32."""
    from . import collective_prec

    rep = local_comm.sum(x) / local_comm.size if local_comm.size > 1 else x
    if wire in ("int8", "blockwise") and collective_prec.compressible(x.dtype):
        return collective_prec.psum(rep, node_comm, wire, block)
    return node_comm.sum(rep.to(torch.bfloat16 if wire == "bf16" else cast_dtype))
