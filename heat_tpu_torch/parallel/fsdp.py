"""Parameter and optimizer-state sharding over the ranks: the FSDP and ZeRO
building blocks (counterpart of ``heat_tpu/parallel/fsdp.py``).

The JAX package places each leaf on its mesh with a ``NamedSharding`` and
lets XLA insert the gathers. Here each rank holds only its part of a leaf
and the gathers are explicit collectives of
:class:`~heat_tpu_torch.core.communication.TorchCommunication`:

* :func:`shard_pytree` / :func:`replicate_pytree` — every leaf as a
  :class:`~heat_tpu_torch.core.dndarray.DNDarray` split along its largest
  axis that divides by the world size (small or indivisible leaves
  replicate), or replicated. There is no ``constrain_pytree``: it pins the
  layout of values inside a traced program, and an eager program holds
  each value where it was made.
* :func:`flat_chunk` / :func:`flat_shard_pytree` — the flat ``1/p`` layout
  of ZeRO and FSDP: a leaf flattened, zero-padded to ``p · chunk`` and cut
  into ``p`` rows; rank ``i`` owns flat elements ``[i·chunk, (i+1)·chunk)``.
  Under a ``blockwise`` wire the chunk is rounded up to whole blocks.
* :class:`PartitionRules` / :func:`plan_partition` / :class:`FsdpPlan` — the
  ordered regex table that maps leaf paths to ``fsdp`` or ``replicate``
  (and optionally a wire); the first match wins and an unmatched leaf
  replicates.
* :func:`fsdp_shard` / :func:`fsdp_unshard` — the persistent layout and the
  topology-independent logical form (checkpoints).
* :func:`fsdp_gather` — the just-in-time weight gather, differentiable: its
  backward is the reduce-scatter of the gradient (each rank gets the sum
  over the ranks of its chunk) at the same wire.

**Leaf paths.** A parameter tree is an ``nn.Module``, a dict (name ->
tensor, possibly nested), or a list or tuple of those (the stages of
:class:`heat_tpu_torch.nn.FSDP`); a leaf's path is its keys joined by
``"/"``, a module's ``named_parameters()`` name with its dots as ``"/"``
(``blocks/0/attn/query``), a stage's index first (``3/ln1/scale``). A flax
path has the variable collection and the kernel's own name as well
(``params/block0/attn/query/kernel`` there is ``blocks/0/attn/query``
here; a ``Dense``'s ``kernel``/``bias`` are a ``Linear``'s
``weight``/``bias``, a LayerNorm's ``scale``/``bias`` keep their names), so
a rule that names the layers (``attn/(query|key|value)``, ``ln``) selects
the same leaves in both packages.
"""

from __future__ import annotations

import ast
import dataclasses
import re
from typing import Any, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

__all__ = [
    "FsdpLeaf",
    "FsdpPlan",
    "PartitionRules",
    "bytes_per_device",
    "flat_chunk",
    "flat_shard_pytree",
    "flat_unshard_leaf",
    "fsdp_gather",
    "fsdp_shard",
    "fsdp_unshard",
    "leaf_paths",
    "plan_partition",
    "replicate_pytree",
    "shard_pytree",
]


# -- trees ----------------------------------------------------------------------------


def _as_tree(tree):
    """An ``nn.Module`` as the dict of its parameters; any other tree as
    it is."""
    if isinstance(tree, nn.Module):
        return dict(tree.named_parameters())
    return tree


def leaf_paths(tree: Any) -> List[Tuple[str, Any]]:
    """``(path, leaf)`` of every leaf in flatten order (dicts in their
    order, lists and tuples by index); module docstring for the paths."""
    out: List[Tuple[str, Any]] = []

    def walk(node, prefix):
        node = _as_tree(node)
        if isinstance(node, dict):
            for key, value in node.items():
                walk(value, prefix + [str(key).replace(".", "/")])
        elif isinstance(node, (list, tuple)):
            for i, value in enumerate(node):
                walk(value, prefix + [str(i)])
        else:
            out.append(("/".join(prefix), node))

    walk(tree, [])
    return out


def _leaves(tree) -> list:
    return [leaf for _, leaf in leaf_paths(tree)]


def _unflatten(like, values: Sequence[Any]):
    """``values`` in ``like``'s structure (a module becomes its parameter
    dict)."""
    it = iter(values)

    def build(node):
        node = _as_tree(node)
        if isinstance(node, dict):
            return {key: build(value) for key, value in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(build(value) for value in node)
        return next(it)

    return build(like)


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


# -- the even shards ---------------------------------------------------------------------


def _split_axis(leaf: torch.Tensor, p: int, min_size: int) -> Optional[int]:
    """The largest axis that divides by ``p`` (None: replicate a small,
    scalar or indivisible leaf)."""
    if leaf.dim() == 0 or leaf.numel() < min_size:
        return None
    for ax in sorted(range(leaf.dim()), key=lambda a: -leaf.shape[a]):
        if leaf.shape[ax] % p == 0 and leaf.shape[ax] >= p:
            return ax
    return None


def shard_pytree(tree: Any, comm=None, *, min_size: int = 1024) -> Any:
    """Every leaf (a tensor the same on every rank) as a DNDarray split
    along its largest axis that divides by the world size; leaves under
    ``min_size`` elements, scalars and indivisible leaves replicate."""
    from ..core import factories
    from ..core.communication import sanitize_comm

    comm = sanitize_comm(comm)
    values = [factories.array(torch.as_tensor(leaf).detach(),
                              split=_split_axis(torch.as_tensor(leaf), comm.size, min_size),
                              device=torch.as_tensor(leaf).device, comm=comm)
              for leaf in _leaves(tree)]
    return _unflatten(tree, values)


def replicate_pytree(tree: Any, comm=None) -> Any:
    """Every leaf whole on every rank (a DNDarray gathered, a tensor as it
    is): the export and checkpoint layout."""
    from ..core.dndarray import DNDarray

    return _unflatten(tree, [leaf._global() if isinstance(leaf, DNDarray) else leaf
                             for leaf in _leaves(tree)])


# -- the flat 1/p layout (ZeRO) -------------------------------------------------------------


def flat_chunk(numel: int, p: int, wire: str = "off", block: int = 128) -> int:
    """Each rank's chunk of a flattened ``numel``-element leaf:
    ``ceil(numel/p)``, rounded up to whole quantization blocks under a
    ``blockwise`` wire (so the compressed reduce-scatter's chunks are the
    state shards)."""
    c = -(-int(numel) // int(p))
    if wire == "blockwise":
        b = max(1, min(int(block), c))
        c = -(-c // b) * b
    return c


def _flat_padded(leaf: torch.Tensor, p: int, chunk: int) -> torch.Tensor:
    flat = leaf.reshape(-1)
    if p * chunk != flat.numel():
        flat = torch.nn.functional.pad(flat, (0, p * chunk - flat.numel()))
    return flat


def _row(leaf: torch.Tensor, rank: int, p: int, chunk: int) -> torch.Tensor:
    """Rank ``rank``'s flat chunk of a whole leaf (a copy)."""
    return _flat_padded(leaf.detach(), p, chunk)[rank * chunk:(rank + 1) * chunk].clone()


def flat_shard_pytree(tree: Any, comm=None, wire: str = "off", block: int = 128) -> Any:
    """Every leaf flattened, zero-padded to ``p · chunk`` and laid out as
    a ``(p, chunk)`` DNDarray split along 0: rank ``i`` holds row ``i``."""
    from ..core import types
    from ..core.communication import sanitize_comm
    from ..core.devices import sanitize_device
    from ..core.dndarray import DNDarray

    comm = sanitize_comm(comm)
    p = comm.size
    out = []
    for leaf in _leaves(tree):
        leaf = torch.as_tensor(leaf)
        c = flat_chunk(leaf.numel(), p, wire, block)
        out.append(DNDarray(_row(leaf, comm.rank, p, c)[None], (p, c),
                            types.canonical_heat_type(leaf.dtype), 0,
                            sanitize_device(leaf.device), comm, True))
    return _unflatten(tree, out)


def flat_unshard_leaf(padded, shape, dtype=None) -> np.ndarray:
    """A ``(p, chunk)`` leaf (a DNDarray, array or tensor) back to its
    logical ``shape`` (the pad cut off). Topology-independent: a leaf
    sharded over 4 ranks unshards to the bytes of one sharded over 8."""
    from ..core.dndarray import DNDarray

    if isinstance(padded, DNDarray):
        padded = padded.numpy()
    elif isinstance(padded, torch.Tensor):
        padded = padded.detach().cpu().numpy()
    flat = np.asarray(padded).reshape(-1)[:_numel(shape)]
    out = flat.reshape(tuple(int(s) for s in shape))
    return out.astype(dtype) if dtype is not None else out


# -- partition rules -------------------------------------------------------------------------

_PLACEMENTS = ("fsdp", "replicate")


@dataclasses.dataclass(frozen=True)
class FsdpLeaf:
    """One leaf's layout: a ``sharded`` leaf lives as each rank's flat
    ``(chunk,)`` row and is gathered at wire ``wire``; a replicated leaf
    keeps its shape on every rank. ``rule`` is the index of the matched
    rule (-1: the replicated default)."""

    path: str
    shape: Tuple[int, ...]
    dtype: str
    sharded: bool
    wire: str
    chunk: int
    rule: int

    @property
    def numel(self) -> int:
        return _numel(self.shape)

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


class PartitionRules:
    """Ordered ``(pattern, placement[, wire])`` rules: ``pattern`` a regex
    ``re.search``-ed in the leaf's path, ``placement`` ``"fsdp"`` or
    ``"replicate"``, ``wire`` the rule's gather wire (``off | bf16 | int8 |
    blockwise``; omitted, :func:`heat_tpu_torch.core.topology.fsdp_wire`).
    The first match wins; unmatched leaves and scalars replicate. ``repr``
    round-trips through :meth:`parse`."""

    def __init__(self, rules: Iterable[Sequence]):
        norm = []
        for r in rules:
            r = tuple(r)
            if len(r) == 2:
                pattern, placement, wire = r[0], r[1], None
            elif len(r) == 3:
                pattern, placement, wire = r
            else:
                raise ValueError(f"rule must be (pattern, placement[, wire]), got {r!r}")
            re.compile(pattern)
            if placement not in _PLACEMENTS:
                raise ValueError(f"placement must be one of {_PLACEMENTS}, got {placement!r} "
                                 f"(rule {pattern!r})")
            if wire is not None:
                from ..core import collective_prec

                if wire not in collective_prec.MODES:
                    raise ValueError(f"wire must be one of {sorted(collective_prec.MODES)}, got "
                                     f"{wire!r} (rule {pattern!r})")
            norm.append((str(pattern), str(placement), wire))
        self.rules: Tuple[Tuple[str, str, Optional[str]], ...] = tuple(norm)

    @classmethod
    def fsdp_default(cls) -> "PartitionRules":
        """Shard every non-scalar leaf."""
        return cls(((".*", "fsdp"),))

    def match(self, path: str) -> Tuple[str, Optional[str], int]:
        """``(placement, wire, rule_index)`` of the first rule whose
        pattern is found in ``path``; ``("replicate", None, -1)`` when none
        is."""
        for i, (pattern, placement, wire) in enumerate(self.rules):
            if re.search(pattern, path):
                return placement, wire, i
        return "replicate", None, -1

    def __repr__(self) -> str:
        return f"PartitionRules({self.rules!r})"

    @classmethod
    def parse(cls, text: str) -> "PartitionRules":
        """Invert :meth:`__repr__` (the bare tuple literal too)."""
        s = text.strip()
        if s.startswith("PartitionRules(") and s.endswith(")"):
            s = s[len("PartitionRules("):-1]
        return cls(ast.literal_eval(s))

    def __eq__(self, other) -> bool:
        return isinstance(other, PartitionRules) and self.rules == other.rules

    def __hash__(self) -> int:
        return hash(self.rules)


class FsdpPlan:
    """The resolved layout of one parameter tree: an :class:`FsdpLeaf` a
    leaf in flatten order, and the tree's structure."""

    def __init__(self, leaves: Sequence[FsdpLeaf], like, p: int):
        self.leaves: Tuple[FsdpLeaf, ...] = tuple(leaves)
        self.like = like
        self.p = int(p)
        self.by_path = {leaf.path: leaf for leaf in self.leaves}

    def signature(self) -> Tuple:
        """Hashable identity of the layout."""
        return tuple((lf.path, lf.shape, lf.dtype, lf.sharded, lf.wire, lf.chunk)
                     for lf in self.leaves) + (self.p,)

    def unflatten(self, values: Sequence[Any]) -> Any:
        return _unflatten(self.like, list(values))

    def sharded_numels(self) -> List[int]:
        return [lf.numel for lf in self.leaves if lf.sharded]

    def __repr__(self) -> str:
        n_sh = sum(1 for lf in self.leaves if lf.sharded)
        return f"FsdpPlan(p={self.p}, leaves={len(self.leaves)}, sharded={n_sh})"


def plan_partition(tree: Any, rules: Optional[PartitionRules], comm=None, *,
                   precision: Optional[str] = None, block: Optional[int] = None) -> FsdpPlan:
    """Resolve ``rules`` over a parameter tree into an :class:`FsdpPlan`.
    Scalars replicate. A sharded leaf's wire is the rule's, else
    ``precision``, else :func:`~heat_tpu_torch.core.topology.fsdp_wire`'s
    chain, and its chunk :func:`flat_chunk` at that wire. A replicated
    leaf whose shape equals a sharded leaf's ``(p, chunk)`` row shape is
    refused, as in the JAX package (its state pairing is by shape)."""
    from ..core import collective_prec, topology
    from ..core.communication import sanitize_comm

    comm = sanitize_comm(comm)
    if rules is None:
        rules = PartitionRules.fsdp_default()
    p = comm.size
    if block is None:
        block = collective_prec.block_size()
    leaves = []
    for path, leaf in leaf_paths(tree):
        shape = tuple(int(s) for s in getattr(leaf, "shape", ()))
        dtype = leaf.dtype if isinstance(leaf, torch.Tensor) else torch.as_tensor(leaf).dtype
        placement, rule_wire, idx = rules.match(path)
        sharded = placement == "fsdp" and len(shape) > 0
        if sharded:
            wire = topology.fsdp_wire(dtype, p, rule_wire if rule_wire is not None else precision,
                                      comm)
            chunk = flat_chunk(_numel(shape), p, wire, block)
        else:
            wire, chunk = "off", 0
        leaves.append(FsdpLeaf(path, shape, str(dtype).replace("torch.", ""), sharded, wire,
                               chunk, idx))
    row_shapes = {(p, lf.chunk) for lf in leaves if lf.sharded}
    for lf in leaves:
        if not lf.sharded and lf.shape in row_shapes:
            raise ValueError(
                f"ambiguous partition plan: replicated leaf {lf.path!r} has logical shape "
                f"{lf.shape}, identical to a sharded leaf's (p, chunk) row shape. Shard that "
                "leaf too, or adjust the rules.")
    return FsdpPlan(leaves, tree, p)


def fsdp_shard(tree: Any, plan: FsdpPlan, comm=None) -> Any:
    """A logical tree (the same on every rank) in ``plan``'s persistent
    layout: a sharded leaf as this rank's flat ``(chunk,)`` row
    (zero-padded tail), a replicated leaf whole. The results are new leaf
    tensors that record gradients."""
    from ..core.communication import sanitize_comm

    comm = sanitize_comm(comm)
    out = []
    for leaf, lp in zip(_leaves(tree), plan.leaves):
        t = torch.as_tensor(leaf).detach()
        if tuple(t.shape) != lp.shape:
            raise ValueError(f"leaf {lp.path!r} has shape {tuple(t.shape)}, plan says "
                             f"{lp.shape}: re-plan before sharding")
        t = _row(t, comm.rank, comm.size, lp.chunk) if lp.sharded else t.clone()
        out.append(t.requires_grad_(t.is_floating_point()))
    return plan.unflatten(out)


def _gather_exact(row: torch.Tensor, comm, p: int, chunk: int) -> torch.Tensor:
    """Every rank's flat ``(chunk,)`` row, concatenated (exact)."""
    return comm.allgather(row.detach(), 0, p * chunk, precision="off")


def _host(t) -> np.ndarray:
    """A tensor on the host as numpy (bf16 as f32, which numpy lacks)."""
    t = torch.as_tensor(t).detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def fsdp_unshard(tree: Any, plan: FsdpPlan, comm=None) -> Any:
    """:func:`fsdp_shard`'s inverse to the topology-independent logical
    form (numpy leaves): the checkpoint layout. A collective: every rank
    calls it."""
    from ..core.communication import sanitize_comm

    comm = sanitize_comm(comm)
    out = []
    for leaf, lp in zip(_leaves(tree), plan.leaves):
        if lp.sharded:
            out.append(flat_unshard_leaf(_host(_gather_exact(leaf, comm, plan.p, lp.chunk)),
                                         lp.shape))
        else:
            out.append(_host(leaf))
    return plan.unflatten(out)


# -- the just-in-time gather ------------------------------------------------------------------


class Prefetched:
    """A weight gather issued ahead of its stage (``HEAT_TPU_FSDP_PREFETCH``):
    :meth:`take` waits for it and hands its result over once; the
    recompute of the stage in the backward finds it empty and gathers
    again."""

    def __init__(self, chunk: torch.Tensor, leaf: FsdpLeaf, comm):
        self._out = self._pending = None
        p = comm.size
        if p == 1:
            self._out = chunk.detach()
        elif leaf.wire == "off" and comm._hier() is None:
            # the exact flat gather travels while the stages before it compute
            self._pending = comm.gather_stack(chunk.detach(), "all_gather", async_op=True)
        else:
            self._out = comm.allgather(chunk.detach(), 0, p * leaf.chunk, precision=leaf.wire)

    def take(self) -> Optional[torch.Tensor]:
        if self._pending is not None:
            self._out, self._pending = self._pending.wait().reshape(-1), None
        out, self._out = self._out, None
        return out


def _tiers_of(comm):
    topo = comm._hier()
    return (topo.node, topo.local) if topo is not None else (1, comm.size)


class _Gather(torch.autograd.Function):
    """The weight gather: forward all-gathers the rank's flat chunk to the
    logical leaf; backward reduce-scatters the gradient (sum over the
    ranks) to the chunk, at the same wire. No residual is kept."""

    @staticmethod
    def forward(ctx, chunk, leaf: FsdpLeaf, comm, block: int, prefetched):
        from .. import telemetry
        from ..telemetry import collectives as costs

        ctx.leaf, ctx.comm, ctx.block = leaf, comm, block
        node, local = _tiers_of(comm)
        telemetry.trace_event(
            "fsdp_gather", path=leaf.path, wire=leaf.wire,
            **costs.fsdp_gather_cost(leaf.chunk, chunk.element_size(), node, local, leaf.wire,
                                     block).as_fields())
        flat = prefetched.take() if prefetched is not None else None
        if flat is None:
            flat = (comm.allgather(chunk.detach(), 0, comm.size * leaf.chunk,
                                   precision=leaf.wire) if comm.size > 1 else chunk.detach())
        return flat[:leaf.numel].reshape(leaf.shape).to(leaf.torch_dtype)

    @staticmethod
    def backward(ctx, grad):
        from .. import telemetry
        from ..telemetry import collectives as costs

        leaf, comm = ctx.leaf, ctx.comm
        p = comm.size
        node, local = _tiers_of(comm)
        telemetry.trace_event(
            "fsdp_scatter", path=leaf.path, wire=leaf.wire,
            **costs.fsdp_scatter_cost(p * leaf.chunk, grad.element_size(), node, local,
                                      leaf.wire, ctx.block).as_fields())
        flat = _flat_padded(grad.contiguous(), p, leaf.chunk)
        g = comm.reduce_scatter_flat(flat, precision=leaf.wire) if p > 1 else flat
        return g[:leaf.chunk], None, None, None, None


def fsdp_gather(local_chunk: torch.Tensor, leaf: FsdpLeaf, comm=None, *,
                block: Optional[int] = None, prefetched: Optional[Prefetched] = None):
    """The logical leaf from this rank's flat ``(chunk,)`` row: an
    all-gather (tiered under ``HEAT_TPU_HIERARCHICAL=1``, at ``leaf.wire``)
    whose backward is the reduce-scatter of the gradient at the same wire.
    A replicated leaf passes through. Emits ``fsdp_gather`` and
    ``fsdp_scatter`` events priced by ``fsdp_gather_cost`` and
    ``fsdp_scatter_cost``. Run the consuming stage under
    ``torch.utils.checkpoint`` so the backward gathers again instead of
    keeping the weights. ``prefetched`` takes a gather issued ahead."""
    from ..core import collective_prec
    from ..core.communication import sanitize_comm

    if not leaf.sharded:
        return local_chunk
    comm = sanitize_comm(comm)
    block = collective_prec.block_size() if block is None else block
    return _Gather.apply(local_chunk, leaf, comm, block, prefetched)


def bytes_per_device(tree: Any) -> int:
    """The bytes this rank holds of a tree (DNDarrays by their local
    chunk, tensors whole): the memory figure FSDP and ZeRO shrink."""
    from ..core.dndarray import DNDarray

    total = 0
    for leaf in _leaves(tree):
        t = leaf.larray if isinstance(leaf, DNDarray) else leaf
        if isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
    return total
