"""heatlint rules HL001–HL006 for the port (counterpart of
``heat_tpu/analysis/rules.py``): the same six rule IDs, each stating the
port's own form of the invariant.

==== ===================================================================
HL001 no CUDA graph capture or ``torch.compile`` outside the program
      registry (``core/program_cache.py``)
HL002 no ``torch.distributed`` collective or point-to-point call outside
      the communicator (``core/communication.py``)
HL003 the exact sites (the moments' and statistics' sums, the gathers of
      ``numpy()`` and ``resplit``) pass no lossy ``precision=`` and resolve
      no lossy wire
HL004 no host sync inside a registry program's body
HL005 every ``HEAT_TPU_*`` environment read goes through ``_knobs``
HL006 no closed-over numeric literal in a ``cached_program`` body
==== ===================================================================

Each rule is a plugin: an object with ``id``/``title``/``rationale``, a
repo-relative ``allowed`` file set where the pattern is sanctioned by
design, and ``scan(ctx) -> (line, col, message)``. New rules register by
appending to :data:`RULES`; ``python -m heat_tpu_torch.analysis
--list-rules`` renders the catalog.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Set, Tuple

from .engine import FileContext

__all__ = ["Rule", "RULES", "rule_by_id"]

Hit = Tuple[int, int, str]


class Rule:
    id: str = "HL000"
    title: str = ""
    rationale: str = ""
    allowed: frozenset = frozenset()

    def scan(self, ctx: FileContext) -> Iterator[Hit]:
        raise NotImplementedError


# -- shared AST helpers -------------------------------------------------------


def _dotted(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _kwarg(call: ast.Call, name: str) -> Optional[ast.expr]:
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def _numeric_literal(node: ast.expr):
    """The int/float value of a literal (incl. unary +/-), else None."""
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, (ast.USub, ast.UAdd)):
        inner = _numeric_literal(node.operand)
        if inner is None:
            return None
        return -inner if isinstance(node.op, ast.USub) else inner
    if isinstance(node, ast.Constant) and isinstance(node.value, (int, float)) \
            and not isinstance(node.value, bool):
        return node.value
    return None


def _aliases(tree: ast.Module, module: str) -> Tuple[Set[str], Dict[str, str]]:
    """``(module aliases, imported names)`` of ``module`` in a file:
    ``import torch.distributed as dist`` gives ``dist``, ``from torch import
    distributed`` gives ``distributed``, ``import torch`` gives
    ``torch.distributed`` for ``torch.distributed``; ``from
    torch.distributed import all_gather as ag`` maps ``ag`` to
    ``all_gather``."""
    parent, _, leaf = module.rpartition(".")
    mods: Set[str] = {module}
    names: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == module and a.asname:
                    mods.add(a.asname)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module == parent:
                for a in node.names:
                    if a.name == leaf:
                        mods.add(a.asname or a.name)
            elif node.module == module:
                for a in node.names:
                    names[a.asname or a.name] = a.name
    return mods, names


def _reference(node: ast.AST, mods: Set[str], names: Dict[str, str]) -> Optional[str]:
    """The member of the aliased module that ``node`` (a Load of a Name or
    an Attribute) refers to, else None."""
    if isinstance(node, ast.Attribute) and isinstance(node.ctx, ast.Load):
        owner = _dotted(node.value)
        if owner in mods:
            return node.attr
    elif isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load) and node.id in names:
        return names[node.id]
    return None


def _program_scopes(ctx: FileContext) -> Set[ast.AST]:
    """Function/lambda nodes that run as a registry program: everything
    inside the ``build`` argument of a ``cached_program`` call (the
    callable ``build()`` returns is the program), with the functions of
    this file that ``build`` names (``lambda: _body``, ``lambda:
    self._step``, ``lambda: partial(_body, n)``). A function of this file
    that ``build`` calls is a builder: the functions it defines are the
    program, its own statements run once at the build."""
    scopes: Set[ast.AST] = set()
    by_name: dict = {}
    for node in ast.walk(ctx.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            by_name.setdefault(node.name, node)

    def local_def(ref: ast.AST):
        if isinstance(ref, ast.Name):
            return by_name.get(ref.id)
        if isinstance(ref, ast.Attribute):
            return by_name.get(ref.attr)
        return None

    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        if not (_dotted(node.func) or "").endswith("cached_program"):
            continue
        build = node.args[2] if len(node.args) > 2 else _kwarg(node, "build")
        if build is None:
            continue
        callees = {id(sub.func) for sub in ast.walk(build) if isinstance(sub, ast.Call)}
        for sub in ast.walk(build):
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                scopes.add(sub)
                continue
            fn = local_def(sub)
            if fn is None:
                continue
            if id(sub) in callees:
                scopes.update(inner for inner in ast.walk(fn) if inner is not fn and isinstance(
                    inner, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)))
            else:
                scopes.add(fn)
    return scopes


# -- HL001: graph capture and compilation only in the registry -----------------

_GRAPH_APIS = frozenset({"graph", "CUDAGraph", "make_graphed_callables", "graph_pool_handle"})


class NoStrayGraph(Rule):
    """No CUDA graph capture or ``torch.compile`` outside the registry."""

    id = "HL001"
    title = "single graph/compile site"
    rationale = (
        "program_cache.cached_program is the ONE sanctioned capture site: it "
        "keys programs so dispatch, fault injection, the memory preflight, "
        "the build events and the autotuner's warm start share one "
        "signature. A private torch.cuda.graph/CUDAGraph, "
        "make_graphed_callables or torch.compile is a program the "
        "registry cannot see: it bypasses the resilience guard and the "
        "site counters, and freezes the knobs its body reads outside any key."
    )
    allowed = frozenset({
        # the registry itself: the sanctioned capture site
        "heat_tpu_torch/core/program_cache.py",
    })

    def scan(self, ctx: FileContext) -> Iterator[Hit]:
        cuda_mods, cuda_names = _aliases(ctx.tree, "torch.cuda")
        torch_mods = {"torch"}
        compiled = {n for n, v in _aliases(ctx.tree, "torch")[1].items() if v == "compile"}
        for node in ast.walk(ctx.tree):
            what = None
            member = _reference(node, cuda_mods, cuda_names)
            if member in _GRAPH_APIS:
                what = f"torch.cuda.{member}"
            elif isinstance(node, ast.Attribute) and isinstance(node.ctx, ast.Load) \
                    and node.attr == "compile" and _dotted(node.value) in torch_mods:
                what = "torch.compile"
            elif isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load) \
                    and node.id in compiled:
                what = "torch.compile"
            if what is not None:
                yield (
                    node.lineno, node.col_offset,
                    f"{what} outside the program registry: route this program "
                    "through heat_tpu_torch.core.program_cache.cached_program so "
                    "its site, faults, builds and knobs are the registry's",
                )


# -- HL002: collectives only in the communicator --------------------------------

_COLLECTIVES = frozenset({
    "all_reduce", "all_gather", "all_gather_into_tensor", "all_gather_object",
    "all_to_all", "all_to_all_single", "broadcast", "broadcast_object_list",
    "reduce", "reduce_scatter", "reduce_scatter_tensor", "gather", "gather_object",
    "scatter", "scatter_object_list", "send", "recv", "isend", "irecv",
    "batch_isend_irecv", "P2POp", "barrier", "monitored_barrier",
    "_all_gather_base", "_reduce_scatter_base",
})


class RawCollective(Rule):
    """Raw ``torch.distributed`` collectives dodge the audit and the cost model."""

    id = "HL002"
    title = "collectives route through the communicator"
    rationale = (
        "Every collective must be visible to the cost model: the "
        "TorchCommunication movers emit the trace events the collective "
        "audit records and the cost model prices, and they are the "
        "collective-precision chokepoint. A raw torch.distributed call is a "
        "hop telemetry.hlo's audit and the planner cannot see."
    )
    allowed = frozenset({
        # the communicator: the one module that talks to torch.distributed
        "heat_tpu_torch/core/communication.py",
    })

    def scan(self, ctx: FileContext) -> Iterator[Hit]:
        mods, names = _aliases(ctx.tree, "torch.distributed")
        for node in ast.walk(ctx.tree):
            member = _reference(node, mods, names)
            if member in _COLLECTIVES:
                yield (
                    node.lineno, node.col_offset,
                    f"raw torch.distributed.{member} - route the hop through "
                    "the communicator (core/communication.py) so the collective "
                    "audit, the cost model and the precision knob see it",
                )


# -- HL003: the exact sites stay exact ------------------------------------------

# fault 15's list: where a lossy collective knob must never reach
EXACT_SITES: Dict[str, frozenset] = {
    # the moments (the K2 kernel's carry and its cross-rank merge)
    "heat_tpu_torch/core/statistics.py": frozenset({
        "_column_moments", "_kernel_moments", "chunk_moments", "_chunk_moments_program",
        "mean", "var", "std"}),
    "heat_tpu_torch/core/cuda_moments.py": frozenset({"sharded_merge"}),
    # the statistics' sums
    "heat_tpu_torch/core/arithmetics.py": frozenset({"sum"}),
    "heat_tpu_torch/core/_operations.py": frozenset({"reduce_op", "_reduce_local"}),
    # the gathers of numpy() and resplit (to None, and a world of one)
    "heat_tpu_torch/core/dndarray.py": frozenset({"_global", "numpy", "_relayout_program"}),
}
_LOSSY_RESOLVERS = frozenset({"resolve", "effective", "cross_mode", "fsdp_wire"})
_LOSSY_MOVERS = frozenset({"reshard", "psum", "pmean", "all_gather", "reduce_scatter",
                           "exchange", "node_mean_cross_sum"})


class ExactPrecisionPin(Rule):
    """The exact sites pass no lossy ``precision=`` and resolve no wire."""

    id = "HL003"
    title = "exact sites move exact"
    rationale = (
        "The moments, the statistics' sums and the gathers of numpy() and "
        "resplit are EXACT by contract: HEAT_TPU_COLLECTIVE_PREC and "
        "HEAT_TPU_HIERARCHICAL_PREC must not reach them. The port's "
        "communicator moves exactly when precision is None or 'off', so "
        "these sites pass no other precision=, resolve no wire mode "
        "(collective_prec.resolve/effective, topology.cross_mode) and call "
        "no lossy mover of collective_prec."
    )

    def scan(self, ctx: FileContext) -> Iterator[Hit]:
        exact = EXACT_SITES.get(ctx.relpath)
        if not exact:
            return
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            chain = [fn.name for fn in ctx.enclosing_functions(node)
                     if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef))]
            site = next((n for n in chain if n in exact), None)
            if site is None:
                continue
            prec = _kwarg(node, "precision")
            dotted = _dotted(node.func) or ""
            owner, _, attr = dotted.rpartition(".")
            if prec is not None and not (
                    isinstance(prec, ast.Constant) and prec.value in (None, "off")):
                yield (
                    node.lineno, node.col_offset,
                    f"exact site {site}() passes precision= other than None/'off' to "
                    f"{dotted or 'a call'}(: a lossy wire would reach bits that are "
                    "load-bearing",
                )
            elif owner.split(".")[-1] in ("collective_prec", "topology") and (
                    attr in _LOSSY_RESOLVERS or attr in _LOSSY_MOVERS):
                yield (
                    node.lineno, node.col_offset,
                    f"exact site {site}() calls {dotted}(: it resolves or moves at the "
                    "lossy collective knobs, which must not reach this site",
                )


# -- HL004: host syncs inside registry programs --------------------------------

_SYNC_METHODS = frozenset({"item", "tolist", "cpu", "numpy"})


class HostSyncInProgram(Rule):
    """No host sync inside a registry program's body."""

    id = "HL004"
    title = "host-sync hazards in registry programs"
    rationale = (
        "A registry program runs on the card as a CUDA graph (captured once, "
        "replayed) or inline on the caller's stream. A host read inside it "
        "(.item(), .tolist(), .cpu(), .numpy(), float/int/bool of a tensor "
        "argument, torch.cuda.synchronize) breaks its capture and stalls "
        "the stream between launches when inline. Read results on the host "
        "OUTSIDE the program body."
    )

    def scan(self, ctx: FileContext) -> Iterator[Hit]:
        scopes = _program_scopes(ctx)
        emitted: Set[Tuple[int, int]] = set()
        for scope in scopes:
            a = scope.args
            params = {p.arg for p in list(a.args) + list(a.posonlyargs) + list(a.kwonlyargs)}
            if a.vararg:
                params.add(a.vararg.arg)
            body = scope.body if isinstance(scope.body, list) else [scope.body]
            for stmt in body:
                for node in ast.walk(stmt):
                    if not isinstance(node, ast.Call):
                        continue
                    dotted = _dotted(node.func) or ""
                    msg = None
                    if isinstance(node.func, ast.Attribute) and \
                            node.func.attr in _SYNC_METHODS and not node.args and \
                            not dotted.startswith(("np.", "numpy.")):
                        msg = (f".{node.func.attr}() inside a registry program is a "
                               "device-host sync: return the tensor and read it outside")
                    elif dotted.endswith("cuda.synchronize") or dotted == "synchronize":
                        msg = ("torch.cuda.synchronize() inside a registry program "
                               "serializes the stream: synchronize at the call site")
                    elif isinstance(node.func, ast.Name) \
                            and node.func.id in ("float", "int", "bool") \
                            and len(node.args) == 1 \
                            and isinstance(node.args[0], ast.Name) \
                            and node.args[0].id in params:
                        msg = (f"{node.func.id}() of argument '{node.args[0].id}' inside a "
                               "registry program reads it on the host: keep it a tensor, "
                               "or read it outside the program")
                    if msg is None:
                        continue
                    loc = (node.lineno, node.col_offset)
                    if loc in emitted:
                        continue
                    emitted.add(loc)
                    yield (*loc, msg)


# -- HL005: HEAT_TPU_* knobs go through the registry ----------------------------

_ENV_READ_FUNCS = ("os.environ.get", "environ.get", "os.getenv", "getenv")
_KNOB_FUNCS = ("raw", "get")


def _registered_knobs() -> frozenset:
    from .. import _knobs

    return _knobs.names()


class KnobRegistry(Rule):
    """Every ``HEAT_TPU_*`` env read goes through heat_tpu_torch._knobs."""

    id = "HL005"
    title = "env knobs via the central registry"
    rationale = (
        "heat_tpu_torch/_knobs.py declares every HEAT_TPU_* variable once, "
        "with type, default, and docstring; the knob table is generated "
        "from it. A direct os.environ read invents an undocumented knob "
        "with a private parse convention and bypasses the overlay the "
        "autotuner installs winners into. Writes are fine; reads must use "
        "knobs.raw()/get()."
    )
    allowed = frozenset({
        "heat_tpu_torch/_knobs.py",   # the one sanctioned environ read
        "heat_tpu_torch/core/knobs.py",
    })

    def scan(self, ctx: FileContext) -> Iterator[Hit]:
        registered = _registered_knobs()
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Call):
                dotted = _dotted(node.func) or ""
                lit = (
                    node.args[0].value
                    if node.args and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)
                    else None
                )
                if dotted in _ENV_READ_FUNCS or dotted.endswith(".getenv"):
                    if lit is not None and lit.startswith("HEAT_TPU_"):
                        yield (
                            node.lineno, node.col_offset,
                            f"direct environ read of {lit} - declare it in "
                            "heat_tpu_torch/_knobs.py and read via "
                            "knobs.raw()/knobs.get() so it carries a type, "
                            "default, and docstring",
                        )
                elif dotted.rpartition(".")[2] in _KNOB_FUNCS and (
                    "knobs" in dotted.rpartition(".")[0]
                ):
                    if lit is not None and lit.startswith("HEAT_TPU_") \
                            and lit not in registered:
                        yield (
                            node.lineno, node.col_offset,
                            f"knobs.{dotted.rpartition('.')[2]}({lit!r}) "
                            "names an UNREGISTERED knob - add it to the "
                            "registry in heat_tpu_torch/_knobs.py first",
                        )
            elif isinstance(node, ast.Subscript) and isinstance(node.ctx, ast.Load):
                dotted = _dotted(node.value) or ""
                if dotted.endswith("environ") \
                        and isinstance(node.slice, ast.Constant) \
                        and isinstance(node.slice.value, str) \
                        and node.slice.value.startswith("HEAT_TPU_"):
                    yield (
                        node.lineno, node.col_offset,
                        f"direct environ[{node.slice.value!r}] read - use "
                        "the knob registry (heat_tpu_torch/_knobs.py)",
                    )


# -- HL006: no closed-over numeric literals in cached programs -------------------


class ClosedOverLiteral(Rule):
    """Numeric literals must enter cached programs as arguments or keys."""

    id = "HL006"
    title = "stale-program hazard: closed-over numeric literal"
    rationale = (
        "A Python float/int from an enclosing scope baked into a "
        "cached_program body is a stale constant: the registry keys the "
        "program on `key`, so the next call with the same key and another "
        "value of the literal replays the first value (a CUDA graph freezes "
        "it at capture). Pass it as an argument, or put it in the key."
    )

    def scan(self, ctx: FileContext) -> Iterator[Hit]:
        for call in ast.walk(ctx.tree):
            if not isinstance(call, ast.Call):
                continue
            dotted = _dotted(call.func) or ""
            if not dotted.endswith("cached_program"):
                continue
            build = call.args[2] if len(call.args) > 2 else _kwarg(call, "build")
            if build is None:
                continue
            enclosing = [
                fn for fn in ctx.enclosing_functions(call)
                if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef))
            ]
            # numeric-literal bindings visible from the call site,
            # innermost scope first
            literal_bindings = {}
            for fn in reversed(enclosing):
                for node in ast.walk(fn):
                    if isinstance(node, ast.Assign):
                        val = _numeric_literal(node.value)
                        if val is None:
                            continue
                        for t in node.targets:
                            if isinstance(t, ast.Name):
                                literal_bindings[t.id] = val
                    elif isinstance(node, ast.AnnAssign) and node.value is not None:
                        val = _numeric_literal(node.value)
                        if val is not None and isinstance(node.target, ast.Name):
                            literal_bindings[node.target.id] = val
            if not literal_bindings:
                continue

            # the function bodies that run: lambdas/defs inside the build
            # arg, plus local defs the build arg references by name
            targets: List[ast.AST] = []
            local_defs = {}
            for fn in enclosing:
                for node in ast.walk(fn):
                    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        local_defs.setdefault(node.name, node)
            for sub in ast.walk(build):
                if isinstance(sub, (ast.Lambda, ast.FunctionDef, ast.AsyncFunctionDef)):
                    targets.append(sub)
                elif isinstance(sub, ast.Name) and sub.id in local_defs:
                    targets.append(local_defs[sub.id])

            seen: Set[Tuple[int, str]] = set()
            for fn in targets:
                bound: Set[str] = set()
                for node in ast.walk(fn):
                    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                        a = node.args
                        bound.update(
                            p.arg for p in
                            list(a.args) + list(a.posonlyargs) + list(a.kwonlyargs)
                        )
                        if a.vararg:
                            bound.add(a.vararg.arg)
                        if a.kwarg:
                            bound.add(a.kwarg.arg)
                    elif isinstance(node, ast.Name) \
                            and isinstance(node.ctx, (ast.Store, ast.Del)):
                        # any local rebinding shadows the outer literal
                        bound.add(node.id)
                    elif isinstance(node, ast.ExceptHandler) and node.name:
                        bound.add(node.name)
                for node in ast.walk(fn):
                    if not isinstance(node, ast.Name) or not isinstance(node.ctx, ast.Load):
                        continue
                    name = node.id
                    if name in bound or name in ctx.module_names \
                            or name not in literal_bindings:
                        continue
                    key = (node.lineno, name)
                    if key in seen:
                        continue
                    seen.add(key)
                    yield (
                        node.lineno, node.col_offset,
                        f"'{name}' (= {literal_bindings[name]!r}) is a "
                        "Python numeric literal closed over by a "
                        "cached_program body - pass it as an argument (or "
                        "key the program on it) so no call replays a stale "
                        "value",
                    )


RULES: List[Rule] = [
    NoStrayGraph(),
    RawCollective(),
    ExactPrecisionPin(),
    HostSyncInProgram(),
    KnobRegistry(),
    ClosedOverLiteral(),
]


def rule_by_id(rule_id: str) -> Rule:
    for r in RULES:
        if r.id == rule_id.upper():
            return r
    raise KeyError(rule_id)
