"""SPMD communication over ``torch.distributed``.

Counterpart of ``heat_tpu/core/communication.py``. The JAX package is one
controller over a device mesh; this package follows the original Heat
instead: one process per GPU, each holding only its own chunk of a split
array, with collectives over ``torch.distributed`` (NCCL on the card, gloo
in the CPU tests). With no process group initialised the world has size 1.

The chunk arithmetic is the JAX package's ceil rule, copied in logic as
functions of an explicit world size ``size`` (``communication.py:158-220``
there): rank ``r`` owns global indices ``[r*c, min((r+1)*c, n))`` with
``c = ceil(n/size)``; tail ranks may own empty ranges. Because every rank
holds only its own rows, no physical tail padding exists here.

A collective along one dimension pads each chunk to ``c`` for the call and
drops the pad again; the unsigned types wider than 8 bits travel as the
signed type of the same width.

``precision=`` (``off | bf16 | int8 | blockwise``) compresses the wire of
``allreduce``/``allreduce_flat``/``allgather``/``reduce_scatter``/
``all_to_all``/``ppermute`` (:mod:`.collective_prec`); float payloads only,
integers always move exact. ``None`` is the exact wire here, on the flat
path and on both tiers: the JAX package's wrappers read
``HEAT_TPU_COLLECTIVE_PREC`` (and, tiered, ``HEAT_TPU_HIERARCHICAL_PREC``)
at every call and its exactness-critical sites pin ``"off"``, while the port
resolves those knobs at the surfaces that may be lossy (``resplit``,
``DataParallel``, ``DASO``, ``ZeroOptimizer``, FSDP, the pipeline) and
passes the mode down, so every other site is exact. Under
``HEAT_TPU_HIERARCHICAL=1`` on a nontrivial ``node x local`` topology
(:mod:`.topology`) the sum all-reduce, the all-gather, the reduce-scatter and
the all-to-all take the tiered lowerings, in-node exact and the cross-node
tier at the call's wire; the node and cross groups are made once for each
communicator (:meth:`TorchCommunication.tiers`), by every rank in the same
order. Each collective moves its payload through one equal-size mover
(``sum``, ``gather_stack``, ``sum_scatter``, ``exchange``, ``ppermute``):
:mod:`.collective_prec` issues it once for the exact wire and once a part
(payload, scales) for a compressed one, under the collective's name.

Autograd sees through the hops that sequence parallelism differentiates:
``ppermute``/``ring_permute`` (its backward sends the gradient along the
inverse permutation) and ``all_to_all`` (its backward is the inverse
``all_to_all``), as JAX's transpose rules do for ``ppermute`` and
``all_to_all``. ``node_local`` splits a world into the two levels DASO
averages over, and ``allreduce_flat`` reduces a list of tensors as one
flat buffer (one collective a training step, as the JAX package's one
``psum``). ``ring_steps`` is the hop loop that every ring of the package
runs.

Every collective a world of several ranks issues reports itself to
:func:`heat_tpu_torch.telemetry.trace_event` (its op, this rank's bytes in
and out at the wire's type, the group size and the ranks that issue it
together): counted always, recorded while telemetry records, and held
against the cost model by the collective audit
(:mod:`heat_tpu_torch.telemetry.hlo`).

``Communication`` is the abstract base the JAX package exports,
``CommunicationError`` its error, and :func:`init_distributed` starts the
process group (NCCL on the card, gloo on the CPU) and rebuilds the default
communicator.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import _knobs as knobs
from .. import telemetry

__all__ = [
    "Communication",
    "CommunicationError",
    "Pending",
    "PendingAllreduce",
    "TorchCommunication",
    "chunk",
    "chunk_size",
    "counts_displs",
    "get_comm",
    "init_distributed",
    "lshape_map",
    "padded_size",
    "ring_overlap",
    "ring_steps",
    "sanitize_comm",
    "use_comm",
]


def chunk_size(n: int, size: int) -> int:
    """Per-rank chunk length ``ceil(n/size)`` for a split dimension of
    length ``n``."""
    if size == 0:
        return n
    return -(-n // size)


def padded_size(n: int, size: int) -> int:
    """``chunk_size * size``: the length the JAX package stores (this
    package stores no pad, but keeps the number for layout parity)."""
    return chunk_size(n, size) * size


def chunk(
    shape: Sequence[int], split: Optional[int], rank: int, size: int
) -> Tuple[int, Tuple[int, ...], Tuple[slice, ...]]:
    """``(offset, local_shape, slices)`` of rank ``rank``'s chunk of a
    global ``shape`` split along ``split``."""
    shape = tuple(int(s) for s in shape)
    if split is None:
        return 0, shape, tuple(slice(0, end) for end in shape)
    n = shape[split]
    c = chunk_size(n, size)
    start = min(rank * c, n)
    end = min((rank + 1) * c, n)
    lshape = shape[:split] + (end - start,) + shape[split + 1:]
    slices = tuple(
        slice(start, end) if d == split else slice(0, shape[d]) for d in range(len(shape))
    )
    return start, lshape, slices


def lshape_map(gshape: Sequence[int], split: Optional[int], size: int) -> np.ndarray:
    """(size, ndim) int64 array of every rank's chunk shape."""
    out = np.empty((size, len(gshape)), dtype=np.int64)
    for r in range(size):
        out[r] = chunk(gshape, split, r, size)[1]
    return out


def counts_displs(n: int, size: int) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """Per-rank counts and displacements along a split dimension of
    length ``n``."""
    c = chunk_size(n, size)
    counts = tuple(max(0, min((r + 1) * c, n) - min(r * c, n)) for r in range(size))
    displs = tuple(min(r * c, n) for r in range(size))
    return counts, displs


def ring_overlap() -> bool:
    """Whether the rings (CholeskyQR2's Gram ring, the ring distances) issue
    each hop before its tile's product and skip the dead last hop
    (``HEAT_TPU_RING_OVERLAP``, default on; ``0``, ``false``, ``off`` or
    ``no`` turn it off). The tiles are the same either way."""
    return bool(knobs.get("HEAT_TPU_RING_OVERLAP"))


def _tree_map(fn, tree):
    """``fn`` on every tensor of a nest of tuples, lists and dicts."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {key: _tree_map(fn, value) for key, value in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, value) for value in tree)
    return tree


def ring_steps(comm: "TorchCommunication", circulating, visit, *, shift: int = 1,
               overlap: bool = False, home: bool = False) -> None:
    """The hop loop of every ring (``ring_pipeline``, ring attention, the
    ring distances, CholeskyQR2's Gram ring): ``visit(t, origin, block)`` at
    each step ``t`` of ``p``, where ``block`` is the circulating block that
    started on rank ``origin = (rank - t * shift) mod p``. Between two steps
    every block moves one hop along ``+shift`` (``ring_permute``;
    ``circulating`` may be a nest of tensors). ``overlap=True`` issues each
    hop before the visit of the block it moves, so the transfer runs under
    the visit; it takes one tensor and records no gradient. The hop after
    the last step only brings every block home, and is made only with
    ``home=True`` (the JAX package's serial schedule)."""
    p = comm.size
    for t in range(p):
        origin = (comm.rank - t * shift) % p
        hop = t < p - 1 or home
        if overlap and hop:
            pending = comm.ring_permute(circulating, shift, async_op=True)
            visit(t, origin, circulating)
            circulating = pending.wait()
            continue
        visit(t, origin, circulating)
        if hop:
            circulating = _tree_map(lambda x: comm.ring_permute(x.contiguous(), shift),
                                    circulating)


# the signed type of the same width, which carries an unsigned type's bits
# through a collective
_BITS_AS = {torch.uint16: torch.int16, torch.uint32: torch.int32, torch.uint64: torch.int64}
_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "prod": dist.ReduceOp.PRODUCT, "max": dist.ReduceOp.MAX,
               "min": dist.ReduceOp.MIN}


def _padded(local: torch.Tensor, dim: int, length: int) -> torch.Tensor:
    """``local`` zero-padded along ``dim`` to ``length`` (no copy when it
    already has that length)."""
    if local.shape[dim] == length:
        return local
    shape = list(local.shape)
    shape[dim] = length
    buf = local.new_zeros(shape)
    buf.narrow(dim, 0, local.shape[dim]).copy_(local)
    return buf


class Pending:
    """A collective in flight (``async_op=True``: :meth:`TorchCommunication.ppermute`,
    :meth:`TorchCommunication.gather_stack`): :meth:`wait` completes it and
    returns the received tensor in its type. It holds the sent tensor until
    then."""

    def __init__(self, out: torch.Tensor, works: list, dtype: torch.dtype, sent: torch.Tensor):
        self._out, self._works, self._dtype, self._sent = out, works, dtype, sent

    def wait(self) -> torch.Tensor:
        for w in self._works:
            w.wait()
        self._works, self._sent = [], None
        return self._out.view(self._dtype)


class PendingAllreduce:
    """An :meth:`TorchCommunication.allreduce_flat` in flight: :meth:`wait`
    completes it and returns the reduced tensors."""

    def __init__(self, flat: torch.Tensor, work, like: Sequence[torch.Tensor], divisor):
        self._flat, self._work, self._like, self._divisor = flat, work, list(like), divisor

    def wait(self) -> List[torch.Tensor]:
        if self._work is not None:
            self._work.wait()
            self._work = None
        if self._divisor is not None:
            self._flat.div_(self._divisor)
            self._divisor = None
        out, offset = [], 0
        for t in self._like:
            n = t.numel()
            out.append(self._flat.narrow(0, offset, n).view(t.shape))
            offset += n
        return out


class _PPermute(torch.autograd.Function):
    """``ppermute`` under autograd: the backward sends the gradient along
    the inverse permutation (a rank that received nothing gets no gradient
    back; one that sent nothing gets zeros)."""

    @staticmethod
    def forward(ctx, tensor, comm, perm, precision=None):
        ctx.comm, ctx.perm = comm, perm
        return comm.ppermute(tensor, perm, precision)

    @staticmethod
    def backward(ctx, grad):
        inverse = [(d, s) for s, d in ctx.perm]
        return ctx.comm.ppermute(grad.contiguous(), inverse), None, None, None


class _AllToAll(torch.autograd.Function):
    """``all_to_all`` under autograd: it moves every element once, so its
    backward is the inverse exchange (the axes and lengths swapped)."""

    @staticmethod
    def forward(ctx, local, comm, split_axis, concat_axis, n_split, n_concat):
        ctx.comm, ctx.args = comm, (concat_axis, split_axis, n_concat, n_split)
        return comm.all_to_all(local, split_axis, concat_axis, n_split, n_concat)

    @staticmethod
    def backward(ctx, grad):
        return (ctx.comm.all_to_all(grad.contiguous(), *ctx.args),
                None, None, None, None, None)


def _records_grad(tensor: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and tensor.requires_grad


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _issued(name: str, op: str, sent: torch.Tensor, size: int, out_shape=None,
            **extra) -> None:
    """Report one collective to telemetry (module docstring): ``sent`` is
    this rank's operand, ``out_shape`` its result's shape (the operand's
    when None); ``participants`` (in ``extra``) counts the ranks of every
    group that issues it together (a tier's groups), ``size`` by default."""
    shape = tuple(sent.shape) if out_shape is None else tuple(out_shape)
    out_bytes = sent.element_size() * int(np.prod(shape, dtype=np.int64))
    telemetry.trace_event(name, op=op, in_bytes=_nbytes(sent), out_bytes=out_bytes,
                          group_size=size, dtype=str(sent.dtype).replace("torch.", ""),
                          shape=list(shape), **extra)


class CommunicationError(RuntimeError):
    """A failure of the communication layer (the JAX package's name)."""


class Communication:
    """The abstract communicator (reference communication.py:88-117), the
    base of :class:`TorchCommunication`."""

    @staticmethod
    def is_distributed() -> bool:
        raise NotImplementedError()

    def chunk(self, shape, split, rank=None):
        raise NotImplementedError()


class TorchCommunication(Communication):
    """The world of ranks of one ``torch.distributed`` process group (the
    default group when ``group`` is None). Without an initialised process
    group it is a world of size 1 and every collective is the identity."""

    def __init__(self, group=None, participants: Optional[int] = None):
        self.group = group
        if dist.is_available() and dist.is_initialized():
            self.size = dist.get_world_size(group)
            self.rank = dist.get_rank(group)
        else:
            self.size = 1
            self.rank = 0
        # the ranks of all the groups that issue this communicator's
        # collectives together (a tier's groups): the audit's participants
        self.participants = self.size if participants is None else int(participants)
        self._tiers = {}
        self._hosts = None

    def __repr__(self) -> str:
        return f"TorchCommunication(rank={self.rank}, size={self.size})"

    def is_distributed(self) -> bool:
        return self.size > 1

    # -- the layout contract (JAX package communication.py:158-220) ----------

    def chunk_size(self, n: int) -> int:
        return chunk_size(n, self.size)

    def padded_size(self, n: int) -> int:
        return padded_size(n, self.size)

    def chunk(self, shape, split, rank: Optional[int] = None):
        return chunk(shape, split, self.rank if rank is None else rank, self.size)

    def lshape_map(self, gshape, split) -> np.ndarray:
        return lshape_map(gshape, split, self.size)

    def counts_displs(self, n: int):
        return counts_displs(n, self.size)

    # -- the 2-level topology (core/topology.py) ---------------------------

    def _hier(self):
        """The topology to lower tiered against, or None for the flat
        path (``HEAT_TPU_HIERARCHICAL=1`` and a nontrivial factorization;
        a tier's own communicator, one of several groups, lowers flat)."""
        from . import topology as _topo

        if (self.size <= 1 or self.participants != self.size
                or not _topo.hierarchical_requested()):
            return None
        return _topo.active(self.size, self)

    @staticmethod
    def _wire(tensor: torch.Tensor, precision: Optional[str]) -> str:
        """The wire of one payload, flat or on the cross-node tier:
        ``precision`` (None is exact, module docstring), ``off`` for integer
        payloads."""
        from . import collective_prec

        return collective_prec.effective(tensor.dtype, "off" if precision is None else precision)

    def tiers(self, topo) -> Tuple["TorchCommunication", "TorchCommunication"]:
        """``(in_node, cross)`` communicators of ``topo`` over this world:
        the ``local`` consecutive ranks of this rank's node, and the ranks
        with this rank's place in every node (the JAX package's
        ``node_groups``/``cross_groups``). Made once for each topology, by
        every rank in the same order (every rank must call it)."""
        key = (topo.node, topo.local)
        if key not in self._tiers:
            cross, in_node = self.node_local(topo.node)
            self._tiers[key] = (in_node, cross)
        return self._tiers[key]

    # -- equal-size primitives (the movers every collective issues) ---------

    @staticmethod
    def _wire_view(tensor: torch.Tensor) -> torch.Tensor:
        """What moves: the signed bits of a wide unsigned type, the bytes of
        a boolean, any other type as it is (a bf16 payload moves as bf16 on
        NCCL and gloo, which carry no int16)."""
        return tensor.view({torch.bool: torch.uint8, **_BITS_AS}.get(tensor.dtype,
                                                                    tensor.dtype)).contiguous()

    def exchange(self, send: torch.Tensor, name: str = "exchange") -> torch.Tensor:
        """All-to-all of equal blocks: ``send[q]`` goes to rank ``q`` and
        the result's row ``r`` came from rank ``r`` (``send``'s leading
        dimension is the world size). ``name`` is the event's."""
        if self.size == 1:
            return send.clone()
        wire = self._wire_view(send)
        recv = torch.empty_like(wire)
        dist.all_to_all_single(recv, wire, group=self.group)
        _issued(name, "all-to-all", wire, self.size, participants=self.participants)
        return recv.view(send.dtype)

    def gather_stack(self, tensor: torch.Tensor, name: str = "gather_stack",
                     async_op: bool = False):
        """Every rank's ``tensor`` (one shape on every rank) stacked along a
        new leading dimension, in rank order; with ``async_op=True`` a
        :class:`Pending` at once, so that work can run while it travels."""
        if self.size == 1:
            out = tensor[None].clone()
            return Pending(out, [], out.dtype, tensor) if async_op else out
        wire = self._wire_view(tensor)
        out = wire.new_empty((self.size * wire.numel(),))
        work = dist.all_gather_into_tensor(out, wire.reshape(-1), group=self.group,
                                           async_op=async_op)
        shape = (self.size,) + tuple(wire.shape)
        _issued(name, "all-gather", wire, self.size, shape, participants=self.participants)
        pending = Pending(out.view(shape), [work] if async_op else [], tensor.dtype, wire)
        return pending if async_op else pending.wait()

    def sum_scatter(self, flat: torch.Tensor, name: str = "sum_scatter",
                    op: str = "sum") -> torch.Tensor:
        """This rank's equal chunk of the elementwise sum (or ``op``) of
        every rank's 1-D ``flat`` (its length a multiple of the world size)."""
        if self.size == 1:
            return flat.clone()
        out = flat.new_empty((flat.numel() // self.size,))
        dist.reduce_scatter_tensor(out, flat.contiguous(), op=_REDUCE_OPS[op], group=self.group)
        _issued(name, "reduce-scatter", flat, self.size, out.shape,
                participants=self.participants)
        return out

    def sum(self, tensor: torch.Tensor, name: str = "sum", out: Optional[torch.Tensor] = None,
            async_op: bool = False):
        """The elementwise sum of every rank's ``tensor`` in its type, into
        ``out`` (a new tensor when None; ``tensor`` itself sums in place);
        with ``async_op=True`` ``(out, work)`` at once."""
        if out is None:
            out = tensor.clone()
        elif out is not tensor:
            out.copy_(tensor)
        work = None
        if self.size > 1:
            work = dist.all_reduce(out, group=self.group, async_op=async_op)
            _issued(name, "all-reduce", out, self.size, participants=self.participants)
        return (out, work) if async_op else out

    # -- collectives ----------------------------------------------------------

    def _sum_into(self, tensor: torch.Tensor, precision: Optional[str], name: str) -> None:
        """Sum ``tensor`` over the ranks in place: tiered under
        ``HEAT_TPU_HIERARCHICAL=1``, at ``precision``'s wire."""
        from . import collective_prec, topology as _topo

        topo, wire = self._hier(), self._wire(tensor, precision)
        if topo is None:
            collective_prec.psum(tensor, self, wire, name=name, out=tensor)
            return
        out = _topo.hier_psum(tensor, self, topo, wire, collective_prec.block_size())
        with torch.no_grad():
            tensor.copy_(out)

    def allreduce(self, tensor: torch.Tensor, op: str = "sum",
                  precision: Optional[str] = None) -> torch.Tensor:
        """In-place all-reduce (the counterpart of the JAX package's
        ``psum`` :336, and of ``pmax``/``pmin``); returns ``tensor``. A sum
        takes the tiered lowering under ``HEAT_TPU_HIERARCHICAL=1`` and a
        compressed wire with ``precision`` (module docstring)."""
        if self.size == 1:
            return tensor
        if op == "sum":
            self._sum_into(tensor, precision, "allreduce")
            return tensor
        dist.all_reduce(tensor, op=_REDUCE_OPS[op], group=self.group)
        _issued("allreduce", "all-reduce", tensor, self.size, participants=self.participants)
        return tensor

    def allreduce_flat(self, tensors: Sequence[torch.Tensor], average: bool = False,
                       async_op: bool = False, precision: Optional[str] = None):
        """Sum (or, with ``average``, average) a list of tensors of one type
        over the ranks as ONE collective on a flat buffer that holds them
        all (DataParallel's gradient bucket: one all-reduce a step). Returns
        the reduced tensors as views of that buffer; the inputs are not
        changed. With ``async_op=True`` it returns a
        :class:`PendingAllreduce` at once (a compressed or tiered wire runs
        at once and returns a completed one)."""
        tensors = list(tensors)
        flat = torch.cat([t.detach().reshape(-1) for t in tensors])
        work = None
        if self.size > 1:
            if async_op and self._hier() is None and self._wire(flat, precision) == "off":
                _, work = self.sum(flat, "allreduce_flat", out=flat, async_op=True)
            else:
                self._sum_into(flat, precision, "allreduce_flat")
        divisor = self.size if average and self.size > 1 else None
        pending = PendingAllreduce(flat, work, tensors, divisor)
        return pending if async_op else pending.wait()

    def bcast(self, tensor: torch.Tensor, root: int = 0) -> torch.Tensor:
        """In-place broadcast of rank ``root``'s ``tensor``; returns it."""
        if self.size > 1:
            dist.broadcast(tensor, self._global_rank(root), group=self.group)
            _issued("bcast", "broadcast", tensor, self.size, participants=self.participants)
        return tensor

    def node_local(self, n_nodes: int) -> Tuple["TorchCommunication", "TorchCommunication"]:
        """Split this world into ``n_nodes`` nodes of ``size / n_nodes``
        consecutive ranks: returns ``(node, local)``, where ``local`` is the
        group of this rank's node and ``node`` the group of the ranks with
        this rank's place in every node (the slow and the fast axis of the
        JAX package's ``("node", "local")`` mesh, device ``i`` at
        ``(i // n_local, i % n_local)``). Every rank must call it, with the
        same ``n_nodes``."""
        if n_nodes <= 0 or self.size % n_nodes:
            raise ValueError(f"world size {self.size} not divisible by n_nodes {n_nodes}")
        n_local = self.size // n_nodes
        if self.size == 1:
            return TorchCommunication(self.group), TorchCommunication(self.group)
        glob = [self._global_rank(r) for r in range(self.size)]
        locals_ = [[glob[n * n_local + i] for i in range(n_local)] for n in range(n_nodes)]
        nodes = [[glob[n * n_local + i] for n in range(n_nodes)] for i in range(n_local)]
        local_group, _ = dist.new_subgroups_by_enumeration(locals_)
        node_group, _ = dist.new_subgroups_by_enumeration(nodes)
        return (TorchCommunication(node_group, self.participants),
                TorchCommunication(local_group, self.participants))

    def allgather(self, local: torch.Tensor, dim: int, n: int,
                  precision: Optional[str] = None) -> torch.Tensor:
        """Concatenate every rank's chunk of a dimension of global length
        ``n`` along ``dim`` (the counterpart of ``all_gather`` :412). The
        chunks follow the ceil rule; each is padded to the chunk size for
        the collective and the pad is dropped again. Tiered under
        ``HEAT_TPU_HIERARCHICAL=1``; ``precision`` compresses the wire."""
        if self.size == 1:
            return local
        if local.dtype in _BITS_AS:  # gloo and NCCL carry no uint16/32/64: move the bits
            return self.allgather(local.view(_BITS_AS[local.dtype]), dim, n).view(local.dtype)
        from . import collective_prec, topology as _topo

        counts, _ = self.counts_displs(n)
        buf = _padded(local, dim, self.chunk_size(n)).contiguous()
        topo, wire = self._hier(), self._wire(buf, precision)
        if topo is not None:
            stacked = _topo.hier_all_gather(buf, self, topo, wire, collective_prec.block_size(),
                                            tiled=False)
        else:
            stacked = collective_prec.all_gather(buf, self, wire, tiled=False, name="all_gather")
        return torch.cat([p.narrow(dim, 0, cnt) for p, cnt in zip(stacked.unbind(0), counts)],
                         dim=dim)

    def reduce_scatter(self, tensor: torch.Tensor, dim: int, n: int, op: str = "sum",
                       precision: Optional[str] = None) -> torch.Tensor:
        """This rank's ceil-rule chunk, along ``dim`` of global length ``n``,
        of the elementwise reduction of every rank's whole ``tensor`` (the
        counterpart of ``reduce_scatter`` :363 and of ``psum_scatter``).
        A sum is tiered under ``HEAT_TPU_HIERARCHICAL=1`` and compressed
        with ``precision``; :meth:`reduce_scatter_flat` is the JAX
        package's flat form."""
        if tensor.shape[dim] != n:
            raise ValueError(
                f"reduce_scatter: dimension {dim} has {tensor.shape[dim]} entries, not {n}")
        if self.size == 1:
            return tensor
        if tensor.dtype in _BITS_AS:  # a sum of the signed bits is the unsigned sum modulo 2^w
            if op != "sum":
                raise TypeError(f"reduce_scatter {op!r} of {tensor.dtype}: only 'sum' is carried")
            return self.reduce_scatter(tensor.view(_BITS_AS[tensor.dtype]), dim, n, op).view(
                tensor.dtype)
        c = self.chunk_size(n)
        counts, _ = self.counts_displs(n)
        buf = _padded(tensor.movedim(dim, 0), 0, c * self.size).contiguous()
        # rank r's flat chunk is its c rows
        per = buf.numel() // self.size
        if op == "sum":
            from . import collective_prec

            # under blockwise each rank's segment is padded to whole blocks
            # (the blocked chunk of the quantized reduce-scatter)
            seg = per
            if self._wire(buf, precision) == "blockwise":
                b = max(1, min(collective_prec.block_size(), per))
                seg = -(-per // b) * b
            flat = buf.reshape(self.size, per)
            if seg != per:
                flat = torch.nn.functional.pad(flat, (0, seg - per))
            rows = self.reduce_scatter_flat(flat.reshape(-1), precision, name="reduce_scatter")
        else:
            rows = self.sum_scatter(buf.reshape(-1), "reduce_scatter", op)
        out = rows[:per].reshape((c,) + tuple(buf.shape[1:]))
        return out.narrow(0, 0, counts[self.rank]).movedim(0, dim)

    def reduce_scatter_flat(self, tensor: torch.Tensor, precision: Optional[str] = None,
                            name: str = "reduce_scatter") -> torch.Tensor:
        """The JAX package's ``reduce_scatter`` (:363): ``tensor`` flattened
        and zero-padded to ``size`` equal chunks; returns this rank's 1-D
        ``(ceil(numel/size),)`` chunk of the sum over the ranks (the ZeRO
        gradient primitive). Tiered under ``HEAT_TPU_HIERARCHICAL=1``, at
        ``precision``'s wire; ``blockwise`` may return a chunk padded to
        whole blocks."""
        from . import collective_prec, topology as _topo

        topo, wire = self._hier(), self._wire(tensor, precision)
        if topo is not None:
            return _topo.hier_reduce_scatter(tensor, self, topo, wire,
                                             collective_prec.block_size())
        return collective_prec.reduce_scatter(tensor, self, wire, name=name)

    def all_to_all(self, local: torch.Tensor, split_axis: int, concat_axis: int, n_split: int,
                   n_concat: Optional[int] = None, precision: Optional[str] = None) -> torch.Tensor:
        """Exchange blocks so that every rank ends with its ceil-rule chunk
        of ``split_axis`` (global length ``n_split``) and all of
        ``concat_axis`` (the counterpart of ``all_to_all`` :472). ``local``
        is this rank's chunk of ``concat_axis`` (global length ``n_concat``;
        found from every rank's length when not given) and spans all of
        ``split_axis``. Each rank sends rank ``q`` only the block ``q`` will
        own; no rank holds the whole array. Blocks are padded to the chunk
        sizes of both axes for the call. Differentiable: under autograd the
        gradient takes the inverse exchange back. Tiered under
        ``HEAT_TPU_HIERARCHICAL=1``; ``precision`` compresses each
        destination's block on its own (:func:`.collective_prec.exchange`)."""
        if _records_grad(local) and self.size > 1:
            if n_concat is None:
                n_concat = sum(self.allgather_object(int(local.shape[concat_axis])))
            return _AllToAll.apply(local, self, split_axis, concat_axis, n_split, n_concat)
        if split_axis == concat_axis:
            raise ValueError("all_to_all: split_axis and concat_axis must differ")
        if local.shape[split_axis] != n_split:
            raise ValueError(f"all_to_all: axis {split_axis} has {local.shape[split_axis]} "
                             f"entries, not {n_split}")
        if self.size == 1:
            return local
        if local.dtype in _BITS_AS:
            return self.all_to_all(local.view(_BITS_AS[local.dtype]), split_axis, concat_axis,
                                   n_split, n_concat).view(local.dtype)
        if n_concat is None:
            n_concat = sum(self.allgather_object(int(local.shape[concat_axis])))
        c_split, c_concat = self.chunk_size(n_split), self.chunk_size(n_concat)
        counts_split, _ = self.counts_displs(n_split)
        counts_concat, _ = self.counts_displs(n_concat)
        # (size, ...) blocks: block q is rank q's part of split_axis, padded
        buf = _padded(_padded(local, split_axis, c_split * self.size), concat_axis, c_concat)
        shape = list(buf.shape)
        shape[split_axis:split_axis + 1] = [self.size, c_split]
        send = buf.reshape(shape).movedim(split_axis, 0).contiguous()
        from . import collective_prec, topology as _topo

        topo, wire = self._hier(), self._wire(send, precision)
        if topo is not None:
            recv = _topo.hier_exchange(send, self, topo, wire, collective_prec.block_size())
        else:
            recv = collective_prec.exchange(send, self, wire, name="all_to_all")
        # recv[r] is rank r's chunk of concat_axis; this rank's part of split_axis
        parts = [recv[r].narrow(split_axis, 0, counts_split[self.rank])
                 .narrow(concat_axis, 0, counts_concat[r]) for r in range(self.size)]
        return torch.cat(parts, dim=concat_axis)

    def ppermute(self, tensor: torch.Tensor, perm: Sequence[Tuple[int, int]],
                 precision: Optional[str] = None, async_op: bool = False):
        """Send ``tensor`` along the ``(source, destination)`` pairs of
        ``perm`` (the counterpart of ``ppermute`` :442): this rank returns
        what its source sent, or zeros when no pair names it as a
        destination. Every rank's tensor has the same shape and type. Built
        on ``batch_isend_irecv``: with ``async_op=True`` it returns a
        :class:`Pending` at once, so that work can run while the
        tensors travel. Differentiable (synchronously): under autograd the
        gradient goes back along the inverse permutation (exact). ``precision`` compresses the hop
        (:func:`.collective_prec.ppermute`; synchronous)."""
        if _records_grad(tensor):
            if async_op:
                raise ValueError("ppermute: async_op=True cannot record a gradient")
            return _PPermute.apply(tensor, self, [tuple(pair) for pair in perm], precision)
        wire = self._wire(tensor, precision)
        if wire != "off":
            from . import collective_prec

            out = collective_prec.ppermute(tensor, self, perm, wire)
            return Pending(out, [], out.dtype, tensor) if async_op else out
        dtype = tensor.dtype
        tensor = tensor.view(_BITS_AS.get(dtype, dtype)).contiguous()
        dst = [d for s, d in perm if s == self.rank]
        src = [s for s, d in perm if d == self.rank]
        if len(dst) > 1 or len(src) > 1:
            raise ValueError(f"ppermute: rank {self.rank} appears more than once in {perm}")
        works, out = [], torch.zeros_like(tensor)
        if dst and dst[0] == self.rank:  # to itself: no message
            out = tensor.clone()
        else:
            ops = []
            if dst:
                ops.append(dist.P2POp(dist.isend, tensor, self._global_rank(dst[0]), self.group))
            if src:
                ops.append(dist.P2POp(dist.irecv, out, self._global_rank(src[0]), self.group))
            if ops:
                works = dist.batch_isend_irecv(ops)
        if self.size > 1:
            _issued("ppermute", "collective-permute", tensor, self.size,
                    pairs=[tuple(pair) for pair in perm], participants=self.participants)
        pending = Pending(out, works, dtype, tensor)
        return pending if async_op else pending.wait()

    def alltoallv(self, send: torch.Tensor, send_counts: Sequence[int],
                  recv_counts: Sequence[int]) -> torch.Tensor:
        """Exchange rows (dimension 0) of uneven counts: the first
        ``send_counts[0]`` rows of ``send`` go to rank 0, the next
        ``send_counts[1]`` to rank 1, and so on; returns the
        ``recv_counts[p]`` rows from each rank ``p``, in rank order (the
        counterpart of an ``all_to_all`` with counts; ``all_to_all_single``
        with split sizes)."""
        if self.size == 1:
            return send
        dtype = send.dtype
        wire = {torch.bool: torch.uint8, **_BITS_AS}.get(dtype, dtype)
        send = send.view(wire).contiguous()
        recv = send.new_empty((sum(recv_counts),) + tuple(send.shape[1:]))
        dist.all_to_all_single(recv, send, output_split_sizes=list(recv_counts),
                               input_split_sizes=list(send_counts), group=self.group)
        row = _nbytes(send) // max(1, send.shape[0])
        _issued("alltoallv", "all-to-all", send, self.size, recv.shape,
                sent_bytes=(sum(send_counts) - send_counts[self.rank]) * row,
                participants=self.participants)
        return recv.view(dtype)

    def _global_rank(self, rank: int) -> int:
        return rank if self.group is None else dist.get_global_rank(self.group, rank)

    def ring_permute(self, tensor: torch.Tensor, shift: int = 1, precision: Optional[str] = None,
                     async_op: bool = False):
        """Circulate around the ring: rank ``i`` sends to ``i + shift`` (the
        counterpart of ``ring_permute`` :454)."""
        perm = [(i, (i + shift) % self.size) for i in range(self.size)]
        return self.ppermute(tensor, perm, precision, async_op)

    def barrier(self) -> None:
        """Wait until every rank of the world has reached this call."""
        if self.size > 1:
            dist.barrier(group=self.group)

    def allgather_object(self, obj) -> list:
        if self.size == 1:
            return [obj]
        out = [None] * self.size
        dist.all_gather_object(out, obj, group=self.group)
        telemetry.trace_event("allgather_object", group_size=self.size)
        return out


_default_comm: Optional[TorchCommunication] = None


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids=None,
    backend: Optional[str] = None,
) -> TorchCommunication:
    """Start the process group of this SPMD program and rebuild the default
    communicator over it (the JAX package's ``init_distributed``, which
    starts ``jax.distributed``). Call once in every process, before any
    array is built: ``coordinator_address`` is rank 0's ``host:port`` (or a
    full ``tcp://`` / ``env://`` init method; None reads ``MASTER_ADDR`` and
    ``MASTER_PORT``), ``num_processes`` the world size and ``process_id``
    this process's rank. ``backend`` defaults to NCCL when a card is
    present, else gloo; with ``local_device_ids`` the process takes the
    first of them as its card. Returns the new default communicator."""
    if dist.is_initialized():
        raise CommunicationError("the process group is already initialised")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if local_device_ids is not None and torch.cuda.is_available():
        ids = [local_device_ids] if isinstance(local_device_ids, int) else list(local_device_ids)
        torch.cuda.set_device(int(ids[0]))
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    kwargs = {}
    if num_processes is not None:
        kwargs["world_size"] = int(num_processes)
    if process_id is not None:
        kwargs["rank"] = int(process_id)
    dist.init_process_group(backend, init_method=init_method, **kwargs)
    comm = TorchCommunication()
    use_comm(comm)
    return comm


def get_comm() -> TorchCommunication:
    """The default communicator: the default process group, built on first
    use (reference communication.py:1874)."""
    global _default_comm
    if _default_comm is None:
        _default_comm = TorchCommunication()
    return _default_comm


def use_comm(comm: Optional[TorchCommunication] = None) -> None:
    """Set the default communicator; ``None`` rebuilds it from the current
    process group (reference communication.py:1904)."""
    global _default_comm
    if comm is not None and not isinstance(comm, TorchCommunication):
        raise TypeError(f"Unknown communication, must be TorchCommunication, got {comm!r}")
    _default_comm = comm if comm is not None else TorchCommunication()


def sanitize_comm(comm: Optional[TorchCommunication]) -> TorchCommunication:
    if comm is None:
        return get_comm()
    if isinstance(comm, TorchCommunication):
        return comm
    raise TypeError(f"Unknown communication, must be TorchCommunication, got {comm!r}")
