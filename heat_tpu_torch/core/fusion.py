"""Deferred elementwise fusion: chains of elementwise ops flush as one
cached program.

Counterpart of ``heat_tpu/core/fusion.py``. ``local_op`` and ``binary_op``
append a :class:`FusedNode` to a DAG carried on the result DNDarray instead
of computing; the first read of the result's ``larray`` (any consumer that
is not itself deferrable: a collective, indexing, ``numpy()``, printing,
``out=``) compiles the DAG into a buffer-free plan, registered once per
structural signature in :mod:`.program_cache` (site ``fusion``), and runs
it. Deferral stops at the depth and node caps (``HEAT_TPU_FUSION_DEPTH``,
default 16; the node cap is 4x), at callables that are not allowlisted
(lambdas, closures), and at layouts that need a collective (a size-1
split operand gathered whole); those take the eager path, the first two
counted as ``fusion.fallbacks``.

Through-reduction absorption and epilogue grafting: a reduction of
``reduce_op`` whose operand is pending absorbs the chain into one program
with the reduction's local part (site ``fusion_reduce``; the allreduce
across ranks follows it); ``mean``/``var`` of a pending 2-D f32 chain graft
it in front of the moments kernel K2 (site ``fusion_moments``, one K2
launch a call, ``statistics``); ``matmul`` of local operands is a lazy
*kernel* node (:func:`defer_matmul`) onto which a bias add, an activation
or a soft-threshold tail graft as its epilogue, so ``dense`` flushes as one
program. ``HEAT_TPU_FUSION_REDUCE=0`` turns absorption and grafting off.

**Bits.** A plan evaluates the very calls the eager wrappers make, in
their order (``_operations._apply`` with the same casts, ``_product`` for
the product, never ``addmm``), so a fused chain gives eager's result bit
for bit. Float and complex scalars are runtime arguments (``x * 2.0`` and
``x * 3.0`` share one program); integer and bool scalars are baked into the
plan. A node's result type and local shape come from evaluating its call
on ``meta`` tensors, the counterpart of ``jax.eval_shape``.

**Bytes on the card.** A fused flush runs its plan inline on the caller's
stream (``cached_program(..., inline=True)``): the registry memoizes the
plan, not a CUDA graph, so no leaf is copied into static inputs, no private
memory pool is made (the registry's LRU bounds the entries, each holding no
tensor), and a flush during another program's capture (a serving
endpoint, Lasso's epoch graph) is recorded into that capture instead of
starting one. A flush moves the bytes eager dispatch moves: the same
kernels on the same inputs. An absorbing program keeps the chain's value
as the node's result, so a second reduction of the same chain (``mean``
then ``var``) reads it instead of recomputing it, and a node consumed by a
second chain is materialized once, where the JAX package re-traces it into
each consumer.

**Mutable leaves.** A torch tensor, unlike a ``jax.Array``, can be written
in place. A pending chain holds its leaf tensors; the package's in-place
writers (``__setitem__``, ``lloc``, ``fill_diagonal``, ``out=``) call
:func:`before_write`, which flushes every pending node that captured the
written storage first, so the chain keeps the value from before the write.
A pending node that another chain consumed is a leaf of that chain once it
is computed: its result registers its pending consumers the same way, so a
write to ``x = a * 2`` after ``y = x + 1`` reaches ``y`` only after ``y``
has computed. Each leaf, and each computed node, also records its version
counter; a flush that finds it moved (a write from outside the package)
raises instead of computing with the new values.

Knobs and API: ``HEAT_TPU_FUSION=0`` restores pure-eager dispatch bit for
bit (default on); :func:`fusing` is a scoped (thread-local) override;
:func:`fuse` decorates a function to run fused and flush its returned
arrays; counters ``fusion.deferred``/``.flushes``/``.nodes_flushed``/
``.fallbacks``/``.reductions_absorbed``/``.epilogues_grafted`` feed
:func:`stats` and, while telemetry records, ``telemetry.report``'s
``fusion`` block. :func:`set_pressure_cap` is the memory guard's first
rung: a depth cap of 1 under budget pressure.
"""

from __future__ import annotations

import functools
import threading
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import _knobs as knobs
from .. import telemetry

__all__ = [
    "DEFAULT_DEPTH",
    "FusedNode",
    "active",
    "before_write",
    "depth_cap",
    "fuse",
    "fusing",
    "node_cap",
    "pressure_cap",
    "reduce_active",
    "register_elementwise",
    "reset_stats",
    "set_pressure_cap",
    "stats",
]

DEFAULT_DEPTH = 16

# the memory guard's window cap under budget pressure (None: no pressure)
_PRESSURE_CAP: Optional[int] = None

_TLS = threading.local()
_LOCK = threading.Lock()
# always-on counters; the tests and chip_smoke read dispatch counts here
_STATS = {"deferred": 0, "flushes": 0, "nodes_flushed": 0, "fallbacks": 0,
          "reductions_absorbed": 0, "epilogues_grafted": 0}


# -- enablement -------------------------------------------------------------------


def active() -> bool:
    """Whether elementwise deferral is on for this thread: a :func:`fusing`
    override wins, else ``HEAT_TPU_FUSION`` (default on), read per call."""
    ov = getattr(_TLS, "override", None)
    if ov is not None:
        return ov
    return bool(knobs.get("HEAT_TPU_FUSION"))


def reduce_active() -> bool:
    """Whether absorption and grafting are on: :func:`active` and
    ``HEAT_TPU_FUSION_REDUCE`` (default on)."""
    return active() and bool(knobs.get("HEAT_TPU_FUSION_REDUCE"))


def depth_cap() -> int:
    """Max chain depth before a forced flush (``HEAT_TPU_FUSION_DEPTH``),
    lowered by the memory guard's pressure cap."""
    n = knobs.get("HEAT_TPU_FUSION_DEPTH")
    cap = n if n > 0 else DEFAULT_DEPTH
    if _PRESSURE_CAP is not None:
        cap = min(cap, _PRESSURE_CAP)
    return cap


def node_cap() -> int:
    """Max DAG size before a forced flush: 4x the depth cap."""
    return 4 * depth_cap()


def set_pressure_cap(cap: Optional[int]) -> None:
    """Install (or with None clear) the memory-pressure window cap
    (``resilience.memory_guard.preflight``'s first rung)."""
    global _PRESSURE_CAP
    _PRESSURE_CAP = int(cap) if cap is not None else None


def pressure_cap() -> Optional[int]:
    """The active memory-pressure cap, or None."""
    return _PRESSURE_CAP


class fusing:
    """``with ht.fusing():`` scopes fusion on for this thread,
    ``fusing(False)`` off. Nestable and exception-safe."""

    def __init__(self, enable: bool = True):
        self._enable = bool(enable)
        self._prev: Any = None

    def __enter__(self) -> "fusing":
        self._prev = getattr(_TLS, "override", None)
        _TLS.override = self._enable
        return self

    def __exit__(self, *exc) -> bool:
        _TLS.override = self._prev
        return False


def _flush_tree(obj):
    """Flush every DNDarray in (nested) tuples, lists and dict values."""
    from .dndarray import DNDarray

    if isinstance(obj, DNDarray):
        obj.larray
    elif isinstance(obj, (tuple, list)):
        for v in obj:
            _flush_tree(v)
    elif isinstance(obj, dict):
        for v in obj.values():
            _flush_tree(v)
    return obj


def fuse(fn: Callable) -> Callable:
    """Decorator: run ``fn`` with fusion on and flush the DNDarrays it
    returns, so the function's return is a materialization boundary."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with fusing(True):
            out = fn(*args, **kwargs)
        return _flush_tree(out)

    return wrapper


def stats() -> dict:
    """The fusion counters and the mean ``nodes_per_flush``."""
    with _LOCK:
        out = dict(_STATS)
    out["nodes_per_flush"] = (round(out["nodes_flushed"] / out["flushes"], 3)
                              if out["flushes"] else 0.0)
    return out


def reset_stats() -> None:
    with _LOCK:
        for k in _STATS:
            _STATS[k] = 0


def _count(key: str, delta: int = 1) -> None:
    with _LOCK:
        _STATS[key] += delta
    if telemetry.enabled():
        telemetry.get_registry().add(f"fusion.{key}", delta)


# -- allowlisted operations ------------------------------------------------------

# module-level helpers allowlisted by object identity (stable per process)
_REGISTERED: Dict[Callable, str] = {}
# torch functions whose result depends on the generator: never deferred
_RANDOM = ("rand", "bernoulli", "normal", "poisson", "multinomial", "dropout", "randint",
           "randn", "randperm", "empty")


def register_elementwise(fn: Callable, name: Optional[str] = None) -> Callable:
    """Allowlist a module-level helper for deferral (decorator); its op id
    is ``module.qualname`` unless ``name`` is given."""
    _REGISTERED[fn] = name or f"{fn.__module__}.{fn.__qualname__}"
    return fn


def _op_id(fn: Callable) -> Optional[str]:
    """A stable identity for an allowlisted callable, or None: registered
    helpers, and module-level functions of ``torch`` that draw no random
    numbers. Lambdas and closures are refused: two closures over other
    constants share a qualname."""
    reg = _REGISTERED.get(fn)
    if reg is not None:
        return reg
    name = getattr(fn, "__qualname__", None) or getattr(fn, "__name__", None)
    mod = getattr(fn, "__module__", None) or ""
    if not name or "<" in name or not (mod == "torch" or mod.startswith("torch.")):
        return None
    if any(name.startswith(r) for r in _RANDOM):
        return None
    _REGISTERED[fn] = f"{mod}.{name}"  # a module-level torch function: stable
    return _REGISTERED[fn]


# -- the DAG ------------------------------------------------------------------------


class _Leaf:
    """A materialized operand: one tensor entering the chain, with its
    version counter at capture."""

    __slots__ = ("buffer", "version")

    def __init__(self, buffer: torch.Tensor):
        self.buffer = buffer
        self.version = buffer._version


class _ScalarOperand:
    """A python or numpy scalar operand (module docstring: float and
    complex values are runtime arguments, int and bool ones baked in)."""

    __slots__ = ("value",)

    def __init__(self, value):
        self.value = value


class FusedNode:
    """One deferred call ``evaluator(fn, *operand values, **kwargs)``.
    ``operands`` are nodes, leaves and scalars; ``pshape``/``dtype`` are
    the local result's; ``buffer`` caches the result once materialized, so
    later consumers enter it as a leaf. ``kernel`` marks a deferred product
    (epilogues graft onto it); ``shared`` marks a node that a second chain
    consumed (it is then materialized once), and ``consumers`` holds weak
    references to the pending nodes that consumed it, until it computes;
    ``version`` is ``buffer``'s version counter when it was computed."""

    __slots__ = ("op_id", "evaluator", "fn", "kwargs", "operands", "pshape", "dtype", "depth",
                 "nnodes", "buffer", "version", "shared", "kernel", "consumers", "__weakref__")

    def __init__(self, op_id, evaluator, fn, kwargs, operands, pshape, dtype):
        self.op_id = op_id
        self.evaluator = evaluator
        self.fn = fn
        self.kwargs = kwargs
        self.operands = tuple(operands)
        self.pshape = tuple(int(s) for s in pshape)
        self.dtype = dtype
        self.kernel = False
        self.shared = False
        self.buffer = None
        self.version = 0
        self.consumers: Optional[List["weakref.ref"]] = None
        d, n = 1, 1
        for o in self.operands:
            if isinstance(o, FusedNode):
                d = max(d, o.depth + 1)
                n += o.nnodes
        self.depth, self.nnodes = d, n

    def materialize(self) -> torch.Tensor:
        """Run the chain as its one cached program (idempotent)."""
        if self.buffer is not None:
            return self.buffer
        from . import program_cache

        sig, plan, args = _compile_plan(self)
        fn = program_cache.cached_program("fusion", sig, lambda: _plan_program(plan),
                                          inline=True)
        _computed(self, fn(*args))
        _note_flush(self, "flush", len(args))
        return self.buffer


def _note_flush(node: FusedNode, event: str, nargs: int) -> None:
    _count("flushes")
    _count("nodes_flushed", node.nnodes)
    if telemetry.enabled():
        telemetry.get_registry().emit("fusion", event, nodes=node.nnodes, depth=node.depth,
                                      args=nargs)


def _scalar_kind(v) -> tuple:
    if isinstance(v, np.generic):
        return ("np", str(v.dtype))
    return ("py", type(v).__name__)


def _compile_plan(root: FusedNode):
    """Post-order walk: ``(signature, plan, args)``. The plan is a
    buffer-free instruction list (``leaf``/``scalar``/``const``/``op``,
    each result in the next slot, the last slot the output); the signature
    is the same walk with leaf shapes and types and scalar kinds in place of
    values; ``args`` are the leaves, then the runtime scalars."""
    plan: List[tuple] = []
    sig: List[tuple] = []
    leaves: List[torch.Tensor] = []
    scalars: List[Any] = []
    leaf_pos: Dict[int, int] = {}
    scalar_pos: Dict[tuple, int] = {}
    slot_of: Dict[int, int] = {}

    def walk(entry) -> int:
        if isinstance(entry, FusedNode) and entry.buffer is not None:
            entry = _result_leaf(entry)
        if isinstance(entry, _Leaf):
            buf = entry.buffer
            if buf._version != entry.version:
                raise RuntimeError(
                    "a tensor held by a pending fused chain was written in place after the "
                    "chain was built; write through the DNDarray (setitem, out=), or read the "
                    "chain's result before the write")
            pos = leaf_pos.get(id(buf))
            if pos is None:
                pos = leaf_pos[id(buf)] = len(leaves)
                leaves.append(buf)
            plan.append(("leaf", pos))
            sig.append(("leaf", pos, tuple(buf.shape), buf.dtype, tuple(buf.stride()),
                        buf.device.type))
            return len(plan) - 1
        if isinstance(entry, _ScalarOperand):
            v = entry.value
            kind = _scalar_kind(v)
            if isinstance(v, (bool, int, np.bool_, np.integer)):
                plan.append(("const", v))
                sig.append(("const",) + kind + (repr(v),))
                return len(plan) - 1
            key = (kind, repr(v))  # repr: 0.0 and -0.0 stay apart
            pos = scalar_pos.get(key)
            if pos is None:
                pos = scalar_pos[key] = len(scalars)
                scalars.append(v)
            plan.append(("scalar", pos))
            sig.append(("scalar", pos) + kind)
            return len(plan) - 1
        slot = slot_of.get(id(entry))
        if slot is not None:
            return slot
        slots = tuple(walk(o) for o in entry.operands)
        plan.append(("op", entry.evaluator, entry.fn, entry.kwargs, slots))
        kw = tuple((k, repr(v) if isinstance(v, float) else v)
                   for k, v in sorted(entry.kwargs.items()))  # repr: 0.0 and -0.0 apart
        sig.append(("op", entry.op_id, kw, slots))
        slot = slot_of[id(entry)] = len(plan) - 1
        return slot

    out = walk(root)
    sig.append(("out", out))
    return tuple(sig), (tuple(plan), out, len(leaves)), leaves + scalars


def _plan_program(plan_tuple):
    """The callable of one plan; it captures the plan alone, never a
    tensor."""
    plan, out_slot, n_leaves = plan_tuple

    def fused_program(*args):
        slots: List[Any] = []
        for ins in plan:
            kind = ins[0]
            if kind == "leaf":
                slots.append(args[ins[1]])
            elif kind == "scalar":
                slots.append(args[n_leaves + ins[1]])
            elif kind == "const":
                slots.append(ins[1])
            else:
                _, evaluator, fn, kw, opnds = ins
                slots.append(evaluator(fn, *(slots[i] for i in opnds), **kw))
        return slots[out_slot]

    return fused_program


# -- the evaluators: the eager wrappers' own calls ---------------------------------------


def _eval_local(operation, x, *, promote=None, unsigned="bits"):
    from ._operations import _apply

    if promote is not None:
        x = x.to(promote)
    return _apply(operation, x, unsigned=unsigned)


def _eval_binary(operation, a, b, *, dtype, unsigned="bits"):
    from ._operations import _apply, _cast

    return _apply(operation, _cast(a, dtype), _cast(b, dtype), unsigned=unsigned)


def _eval_narrow(_, x, *, dim, start, length):
    return x.narrow(dim, start, length)


def _eval_matmul(_, x, y, *, tdt):
    from .linalg.basics import _product

    return _product(x.to(tdt), y.to(tdt))


# -- capture bookkeeping ---------------------------------------------------------------

# storage pointer -> the pending nodes that hold a leaf on that storage;
# swept of dead nodes whenever it doubles
_READERS: Dict[int, List["weakref.ref"]] = {}
_READERS_LOCK = threading.Lock()
_READERS_SWEEP = [1024]


def _storage_key(t: torch.Tensor) -> Optional[int]:
    try:
        return t.untyped_storage().data_ptr()
    except (RuntimeError, NotImplementedError):
        return None


def before_write(t: torch.Tensor) -> None:
    """Flush every pending node that captured ``t``'s storage: called by the
    package's in-place writers before they write, so a pending chain keeps
    the value from before the write."""
    if not _READERS:
        return
    key = _storage_key(t)
    with _READERS_LOCK:
        refs = _READERS.pop(key, None)
    for r in refs or ():
        node = r()
        if node is not None and node.buffer is None:
            node.materialize()


def _register(buf: torch.Tensor, node: FusedNode) -> None:
    """Record that pending ``node`` reads ``buf``'s storage, for
    :func:`before_write`."""
    key = _storage_key(buf)
    if key is None:
        return
    with _READERS_LOCK:
        refs = _READERS.setdefault(key, [])
        refs[:] = [r for r in refs if r() is not None]
        refs.append(weakref.ref(node))
        if len(_READERS) > _READERS_SWEEP[0]:
            for k in [k for k, rs in _READERS.items() if all(r() is None for r in rs)]:
                del _READERS[k]
            _READERS_SWEEP[0] = max(1024, 2 * len(_READERS))


def _computed(node: FusedNode, buf: torch.Tensor) -> None:
    """``buf`` is ``node``'s result: record its version, and register the
    pending nodes that consumed ``node`` under its storage, since they now
    read ``buf`` as a leaf (module docstring, mutable leaves)."""
    node.buffer, node.version = buf, buf._version
    refs, node.consumers = node.consumers, None
    for r in refs or ():
        c = r()
        if c is not None and c.buffer is None:
            _register(buf, c)


def _result_leaf(node: FusedNode) -> _Leaf:
    """A computed node as a leaf, with the version of its result when it
    was computed."""
    leaf = _Leaf(node.buffer)
    leaf.version = node.version
    return leaf


def _commit_captures(node: FusedNode, entries) -> None:
    """Record what a new node consumed: leaves register for
    :func:`before_write`; a pending operand node becomes shared and keeps
    ``node`` among its consumers (a kernel node consumed this way is an
    epilogue graft)."""
    for e in entries:
        if isinstance(e, _Leaf):
            _register(e.buffer, node)
        elif isinstance(e, FusedNode) and e.buffer is None:
            e.shared = True
            if e.consumers is None:
                e.consumers = []
            e.consumers.append(weakref.ref(node))
            if e.kernel:
                _count("epilogues_grafted")
                if telemetry.enabled():
                    telemetry.get_registry().emit("fusion", "epilogue_graft", kernel=e.op_id)


def _entry_of(a):
    """DNDarray -> DAG entry: its pending node, or a leaf of its tensor. A
    pending node that an earlier chain already consumed is materialized
    here and enters as a leaf: computed once, as eager dispatch computes
    it."""
    node = a._fused_node()
    if node is not None:
        if node.buffer is None and node.shared:
            node.materialize()
        if node.buffer is None:
            return node
        return _result_leaf(node)
    return _Leaf(a.larray)


def _meta(entry):
    """The entry as ``meta`` tensors see it (scalars pass as values)."""
    if isinstance(entry, FusedNode):
        return torch.empty(entry.pshape, dtype=entry.dtype, device="meta")
    if isinstance(entry, _Leaf):
        return torch.empty(tuple(entry.buffer.shape), dtype=entry.buffer.dtype, device="meta")
    return entry.value


def _grad_leaf(entries) -> bool:
    return any(isinstance(e, _Leaf) and e.buffer.requires_grad for e in entries)


def _fallback():
    _count("fallbacks")
    return None


def _wrap(node: FusedNode, entries, gshape, split, device, comm):
    """Commit the node and hand back its deferred DNDarray, or, at the depth
    or node cap, its materialized one."""
    from . import types
    from .dndarray import DNDarray

    _commit_captures(node, entries)
    _count("deferred")
    ht_dtype = types.canonical_heat_type(node.dtype)
    if node.depth >= depth_cap() or node.nnodes >= node_cap():
        return DNDarray(node.materialize(), gshape, ht_dtype, split, device, comm, True)
    return DNDarray._from_fused(node, gshape, ht_dtype, split, device, comm)


# (call, operand shapes/types/scalar kinds) -> (shape, dtype) or None: a
# meta evaluation costs ~0.1 ms of python, a dict lookup does not
_TYPED: Dict[tuple, Optional[tuple]] = {}
_TYPED_MAX = 4096


def _desc(entry) -> tuple:
    """What a meta evaluation of ``entry`` depends on."""
    if isinstance(entry, FusedNode):
        return (entry.pshape, entry.dtype)
    if isinstance(entry, _Leaf):
        return (tuple(entry.buffer.shape), entry.buffer.dtype)
    v = entry.value
    exact = isinstance(v, (bool, int, np.bool_, np.integer))
    return _scalar_kind(v) + ((repr(v),) if exact else ())


def _typed(key: tuple, compute: Callable):
    """``compute()``'s value memoized under ``key`` (None for a failure)."""
    try:
        return _TYPED[key]
    except KeyError:
        pass
    try:
        val = compute()
    except Exception:
        val = None
    if len(_TYPED) >= _TYPED_MAX:
        _TYPED.clear()
    _TYPED[key] = val
    return val


def _node(op_id, evaluator, fn, kwargs, entries):
    """A node of ``evaluator(fn, *entries, **kwargs)`` typed and shaped on
    meta tensors (memoized); None when that evaluation fails."""
    def compute():
        out = evaluator(fn, *(_meta(e) for e in entries), **kwargs)
        if not isinstance(out, torch.Tensor) or out.device.type != "meta":
            return None
        return tuple(out.shape), out.dtype

    kw = tuple((k, repr(v) if isinstance(v, float) else v) for k, v in sorted(kwargs.items()))
    typed = _typed((op_id, evaluator, fn, kw) + tuple(_desc(e) for e in entries), compute)
    if typed is None:
        return None
    return FusedNode(op_id, evaluator, fn, kwargs, entries, typed[0], typed[1])


# -- the deferral entry points (called by _operations and linalg) -----------------------


def defer_local(operation: Callable, x, promote_exact: bool, unsigned: str):
    """Lazy twin of ``local_op``: a deferred DNDarray, or None for the eager
    path."""
    if not active():
        return None
    op_id = _op_id(operation)
    if op_id is None:
        return _fallback()
    entry = _entry_of(x)
    if _grad_leaf([entry]):
        return None
    promote = None
    if promote_exact:
        from ._operations import _INEXACT

        dt = entry.dtype if isinstance(entry, FusedNode) else entry.buffer.dtype
        promote = _INEXACT.get(dt, dt)
    node = _node(op_id, _eval_local, operation, {"promote": promote, "unsigned": unsigned},
                 [entry])
    if node is None:
        return _fallback()
    return _wrap(node, [entry], x.shape, x.split, x.device, x.comm)


def defer_unary(op_id: str, evaluator: Callable, x, kwargs: dict):
    """Lazy twin of an elementwise wrapper of its own (``clip``): the node
    ``evaluator(None, x's value, **kwargs)``, its static ``kwargs`` part of
    the signature. None for the eager path."""
    if not active():
        return None
    entry = _entry_of(x)
    if _grad_leaf([entry]):
        return None
    node = _node(op_id, evaluator, None, dict(kwargs), [entry])
    if node is None:
        return _fallback()
    return _wrap(node, [entry], x.shape, x.split, x.device, x.comm)


def defer_binary(operation: Callable, t1, t2, s1, s2, out_shape, out_split, inexact: bool,
                 unsigned: str, comm, device):
    """Lazy twin of ``binary_op`` (operands normalized and splits reconciled
    by the caller): the replicated operand's cut to this rank's chunk is a
    ``narrow`` node; an operand that must be gathered whole takes the eager
    path."""
    from ._operations import _INEXACT, result_type
    from .dndarray import DNDarray

    if not active():
        return None
    op_id = _op_id(operation)
    if op_id is None:
        return _fallback()
    ndim_out = len(out_shape)
    entries, plain = [], []
    for a, s in ((t1, s1), (t2, s2)):
        if not isinstance(a, DNDarray):
            entries.append(_ScalarOperand(a))
            plain.append(None)
            continue
        if s is not None and a.shape[a.split] != out_shape[s]:
            return None  # a size-1 split operand is gathered whole: eager
        e = _entry_of(a)
        plain.append(e)
        if out_split is not None and a.split is None:
            own_dim = out_split - (ndim_out - a.ndim)
            shape = e.pshape if isinstance(e, FusedNode) else tuple(e.buffer.shape)
            if own_dim >= 0 and shape[own_dim] == out_shape[out_split] \
                    and out_shape[out_split] != 1:
                _, _, slices = comm.chunk(out_shape, out_split)
                sl = slices[out_split]
                kw = {"dim": own_dim, "start": sl.start, "length": sl.stop - sl.start}
                e = _node("narrow", _eval_narrow, None, kw, [e])
                if e is None:
                    return _fallback()
        entries.append(e)
    if _grad_leaf([e for e in plain if e is not None]):
        return None
    dtype = _typed(("result_type",) + tuple(_desc(e) for e in entries),
                   lambda: result_type(*(_meta(e) for e in entries)))
    if dtype is None:
        return _fallback()
    if inexact:
        dtype = _INEXACT.get(dtype, dtype)
    node = _node(op_id, _eval_binary, operation, {"dtype": dtype, "unsigned": unsigned}, entries)
    if node is None:
        return _fallback()
    # the captures are the operands' own entries (a narrow node is new and
    # is consumed here alone)
    return _wrap(node, [e for e in plain if e is not None], out_shape, out_split, device, comm)


def defer_matmul(a, b, tdt: torch.dtype, out_dtype, out_gshape, out_split):
    """Lazy kernel node for a local ``matmul`` of two 2-D operands: pending
    operand chains graft in front, and elementwise consumers (bias,
    activation, soft threshold) graft onto it as its epilogue; the product
    is ``linalg.basics._product`` (``torch.matmul``), as eager's. None for
    the eager path."""
    if not reduce_active():
        return None
    ea, eb = _entry_of(a), _entry_of(b)
    if _grad_leaf([ea, eb]):
        return None
    if not tdt.is_floating_point:
        return None  # the exact products take their own limb arithmetic: eager
    # the product's local shape and type, known without evaluating it
    shape_a = ea.pshape if isinstance(ea, FusedNode) else tuple(ea.buffer.shape)
    shape_b = eb.pshape if isinstance(eb, FusedNode) else tuple(eb.buffer.shape)
    node = FusedNode("matmul", _eval_matmul, None, {"tdt": tdt}, (ea, eb),
                     (shape_a[0], shape_b[1]), tdt)
    node.kernel = True
    return _wrap(node, [ea, eb], out_gshape, out_split, a.device, a.comm)


# -- absorption ----------------------------------------------------------------------------


def _note_absorbed(node: FusedNode, site: str, **fields) -> None:
    _count("flushes")
    _count("nodes_flushed", node.nnodes)
    _count("reductions_absorbed")
    if telemetry.enabled():
        telemetry.get_registry().emit("fusion", site, nodes=node.nnodes, **fields)


def absorbing(x) -> Optional[FusedNode]:
    """``x``'s pending node when a consumer may absorb it, else None."""
    node = x._fused_node()
    if node is None or node.buffer is not None or not reduce_active():
        return None
    return node


def absorb(node: FusedNode, site: str, key: tuple, tail: Callable, **fields):
    """Run ``node``'s chain and ``tail(chain value)`` as one cached program
    (``site``, signature = chain signature + ``key``); the chain's value
    becomes the node's result (module docstring) and ``tail``'s is
    returned."""
    from . import program_cache

    sig, plan, args = _compile_plan(node)

    def build():
        chain = _plan_program(plan)

        def program(*a):
            val = chain(*a)
            return val, tail(val)

        return program

    fn = program_cache.cached_program(site, sig + (key,), build, inline=True)
    val, out = fn(*args)
    _computed(node, val)
    _note_absorbed(node, site, **fields)
    return out
