"""Offline candidate pruning (counterpart of ``heat_tpu/autotune/cost.py``):
the analytic collective cost model plus the relayout planner's temporary
model rank the lattice before anything is measured.

A *cost function* maps one config dict to a predicted scalar (lower is
better; ``inf`` = infeasible, pruned outright). The built-in
:func:`relayout_cost_fn` prices the relayout family the same way the
planner and the HLO auditor do — wire bytes from
:mod:`heat_tpu_torch.telemetry.collectives` (``precision=`` included, so a
compressed candidate is priced byte-for-byte like the program it would
dispatch) and per-rank temporary bytes from
:mod:`heat_tpu_torch.core.relayout_planner` (``monolithic_need``,
``chunk_stage_need``; optionally replaced by a measured figure, exactly
like ``plan(measured_need=...)``). :func:`fsdp_cost_fn` and
:func:`pipeline_cost_fn` sit on :mod:`heat_tpu_torch.parallel.fsdp` and
:mod:`heat_tpu_torch.parallel.schedule`'s tables. Every figure is the JAX
package's for the same signature. Sites without an analytic model skip
pruning and go straight to measured trials.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence

__all__ = [
    "prune", "rank", "relayout_cost_fn", "fsdp_cost_fn", "pipeline_cost_fn",
]

ConfigCost = Callable[[Dict[str, str]], float]


def rank(
    configs: List[Dict[str, str]], cost_fn: ConfigCost
) -> List[tuple]:
    """``(predicted_cost, lattice_index, config)`` rows sorted by the
    analytic model (stable on ties via the lattice index). A cost
    function that raises for a config marks it infeasible rather than
    killing the tune."""
    rows = []
    for i, cfg in enumerate(configs):
        try:
            c = float(cost_fn(cfg))
        except Exception:
            c = math.inf
        rows.append((c, i, cfg))
    return sorted(rows, key=lambda r: (r[0], r[1]))


def prune(
    configs: List[Dict[str, str]],
    cost_fn: Optional[ConfigCost],
    *,
    keep: int = 8,
) -> List[Dict[str, str]]:
    """The configs that graduate to measured trials: the default config
    (``configs[0]``) unconditionally — the never-worse guarantee needs
    its measured wall — plus the ``keep - 1`` analytically cheapest
    feasible challengers, in predicted order. ``cost_fn=None`` skips
    pruning entirely (no analytic model for this site: every lattice
    candidate is measured, so callers without a model keep their search
    lists small)."""
    if cost_fn is None or len(configs) <= 1:
        return list(configs)
    default = configs[0]
    kept = [default]
    for c, i, cfg in rank(configs[1:], cost_fn):
        if len(kept) >= max(1, keep):
            break
        if math.isinf(c):
            continue
        kept.append(cfg)
    return kept


def fsdp_cost_fn(
    leaf_numels: Sequence[int],
    itemsize: int,
    nproc: int,
    *,
    dtype: str = "float32",
) -> ConfigCost:
    """Analytic cost of one FSDP training step under a
    candidate config: per sharded leaf, one just-in-time weight gather
    in the forward, one re-gather in the rematerialized backward, and
    one gradient reduce-scatter — priced by
    :func:`heat_tpu_torch.telemetry.collectives.fsdp_gather_cost` /
    ``fsdp_scatter_cost`` at the candidate's wire precision
    (``HEAT_TPU_FSDP_PREC``, falling back through the tiered cross-node
    chain exactly like :func:`heat_tpu_torch.core.topology.fsdp_wire`).

    Prefetch depth (``HEAT_TPU_FSDP_PREFETCH``) moves no bytes — it is
    pure scheduling — so it is modelled as *exposure*: depth ``d``
    overlaps gathers with compute, leaving roughly ``1/(d+1)`` of the
    gather volume on the critical path, while the backward's scatter
    stream stays exposed. That is enough for the analytic stage to rank
    prefetch>0 above serial without pretending to know the GEMM wall;
    measured trials settle the rest. Topology-aware DCN pricing arms
    only when the lattice searches ``HEAT_TPU_HIERARCHICAL``, mirroring
    :func:`relayout_cost_fn`."""
    from ..telemetry import collectives as model

    numels = [int(n) for n in leaf_numels]

    def fn(config: Dict[str, str]) -> float:
        from ..core import collective_prec, topology

        prec = (config.get("HEAT_TPU_FSDP_PREC") or "").strip() or None
        if prec is None:
            prec = (
                config.get("HEAT_TPU_HIERARCHICAL_PREC") or ""
            ).strip() or None
        if prec is None:
            prec = (config.get("HEAT_TPU_COLLECTIVE_PREC") or "off").strip()
        prec = collective_prec.effective(dtype, prec)
        try:
            block = int(config.get("HEAT_TPU_COLLECTIVE_PREC_BLOCK") or 0)
        except ValueError:
            block = 0
        block = block if block > 0 else model.DEFAULT_WIRE_BLOCK
        try:
            depth = int(config.get("HEAT_TPU_FSDP_PREFETCH") or 0)
        except ValueError:
            return math.inf
        if depth < 0:
            return math.inf
        searching_hier = "HEAT_TPU_HIERARCHICAL" in config
        hier_on = (config.get("HEAT_TPU_HIERARCHICAL") or "0").strip() in (
            "1", "true", "yes", "on",
        )
        topo = topology.resolve(nproc)
        tiered = hier_on and topo.nontrivial
        node, local = (topo.node, topo.local) if tiered else (1, nproc)
        gathers: List = []
        scatters: List = []
        for numel in numels:
            chunk = -(-numel // nproc)
            if prec == "blockwise":
                chunk = -(-chunk // block) * block
            gathers.append(
                model.fsdp_gather_cost(
                    chunk, itemsize, node, local, prec, block=block
                )
            )
            scatters.append(
                model.fsdp_scatter_cost(
                    chunk * nproc, itemsize, node, local, prec, block=block
                )
            )
        premium = None
        if searching_hier:
            try:
                premium = float(config.get("HEAT_TPU_DCN_PREMIUM") or 0)
            except ValueError:
                premium = 0.0
            if premium <= 0:
                premium = None  # weighted_wire falls back to the live knob

        def price(c) -> float:
            if not searching_hier:
                return float(c.bytes)
            if topo.nontrivial and not c.dcn_bytes and c.bytes:
                # flat lowering on a 2-level topology: all bytes ride DCN
                c = model.CollectiveCost(
                    c.kind, c.bytes, steps=c.steps, dcn_bytes=c.bytes
                )
            return float(model.weighted_wire(c, premium))

        gather_wall = 2.0 * sum(price(c) for c in gathers)
        scatter_wall = sum(price(c) for c in scatters)
        return scatter_wall + gather_wall / float(depth + 1)

    return fn


def pipeline_cost_fn(
    layer_numels: Sequence[int],
    n_layers: int,
    batch: int,
    feat_numel: int,
    itemsize: int,
    nproc: int,
    *,
    n_stages: Optional[int] = None,
    budget: Optional[int] = None,
    dtype: str = "float32",
) -> ConfigCost:
    """Analytic cost of one pipeline training step under a
    candidate config over the ``schedule × microbatch-count × prefetch ×
    wire`` lattice (``HEAT_TPU_PIPELINE_SCHEDULE``,
    ``HEAT_TPU_PIPELINE_MICROBATCHES``, ``HEAT_TPU_FSDP_PREFETCH``,
    ``HEAT_TPU_FSDP_PREC``). Three terms, all in (weighted) wire-byte
    units, straight from the schedule table the candidate would compile:

    * **hops** — every tick moves one collective-permute per direction,
      priced by :func:`heat_tpu_torch.telemetry.collectives.pipeline_hop_cost`
      (DCN-weighted under a searched ``HEAT_TPU_HIERARCHICAL``, mirroring
      :func:`relayout_cost_fn`'s premium arming rule).
    * **gathers** — each (layer, microbatch, direction) is one in-stage
      grouped all-gather (ICI tier, never DCN); the forward share rides
      the prefetch window like :func:`fsdp_cost_fn` (``1/(d+1)``
      exposure), the backward re-gather stays exposed.
    * **bubble exposure** — ``steady_bubble_ticks`` (the schedule-shaped
      figure; total bubble cells are IDENTICAL across gpipe/1f1b at one
      ``(S, M)``) times the mean busy-cell compute proxy, which is what
      ranks 1f1b above gpipe and larger ``M`` above smaller before
      anything is measured.

    Feasibility: the candidate's activation stash
    (``stash_depth × microbatch bytes``, per stage) must fit ``budget``
    when one is given — gpipe at large ``M`` prunes to ``inf`` exactly
    where 1f1b's ``min(S, M)`` stash survives. Microbatch counts that do
    not divide the batch (or stage counts that do not divide the mesh or
    the layer count) are ``inf``. M changes the accumulation grouping, so
    its axis is neutral-kind in the knob registry: the tuner only adopts
    a different M through guarded measured trials; this model just ranks
    the candidates it measures first."""
    from ..telemetry import collectives as model

    numels = [int(n) for n in layer_numels]
    n_layers = int(n_layers)
    batch = int(batch)

    def fn(config: Dict[str, str]) -> float:
        from ..core import collective_prec, topology
        from ..parallel import schedule as sched_mod

        sched = (
            config.get("HEAT_TPU_PIPELINE_SCHEDULE") or "gpipe"
        ).strip().lower()
        if sched not in sched_mod.SCHEDULES:
            return math.inf
        searching_hier = "HEAT_TPU_HIERARCHICAL" in config
        hier_on = (config.get("HEAT_TPU_HIERARCHICAL") or "0").strip() in (
            "1", "true", "yes", "on",
        )
        topo = topology.resolve(nproc)
        tiered = hier_on and topo.nontrivial
        S = n_stages
        if S is None:
            try:
                S = int(config.get("HEAT_TPU_PIPELINE_STAGES") or 0)
            except ValueError:
                return math.inf
        if S == 0:
            S = topo.node if tiered else nproc
        if S < 1 or nproc % S or n_layers % S:
            return math.inf
        local = nproc // S
        try:
            M = int(config.get("HEAT_TPU_PIPELINE_MICROBATCHES") or 0)
        except ValueError:
            return math.inf
        M = M if M > 0 else S
        if batch % M:
            return math.inf
        try:
            depth = int(config.get("HEAT_TPU_FSDP_PREFETCH") or 0)
        except ValueError:
            return math.inf
        if depth < 0:
            return math.inf
        prec = (config.get("HEAT_TPU_FSDP_PREC") or "").strip() or None
        if prec is None:
            prec = (
                config.get("HEAT_TPU_HIERARCHICAL_PREC") or ""
            ).strip() or None
        if prec is None:
            prec = (config.get("HEAT_TPU_COLLECTIVE_PREC") or "off").strip()
        prec = collective_prec.effective(dtype, prec)
        if prec in ("int8", "blockwise"):
            prec = "bf16"  # the pipeline gather coercion (plan_pipeline)
        wire_item = 2 if prec == "bf16" else itemsize

        table = sched_mod.build_schedule(S, M, sched, train=True)
        mb = batch // M
        if budget is not None:
            stash_bytes = (
                table.stash_depth() * mb * int(feat_numel) * itemsize
            )
            if stash_bytes > budget:
                return math.inf

        hop = model.pipeline_hop_cost(
            mb, int(feat_numel), itemsize, nproc,
            stride=local, local=topo.local if tiered else None,
        )
        premium = None
        if searching_hier:
            try:
                premium = float(config.get("HEAT_TPU_DCN_PREMIUM") or 0)
            except ValueError:
                premium = 0.0
            if premium <= 0:
                premium = None  # weighted_wire falls back to the live knob
        hop_price = (
            model.weighted_wire(hop, premium)
            if searching_hier
            else float(hop.bytes)
        )
        # the kernel skips the final tick's hops (no consumer), so a
        # compiled step carries 2 x (n_ticks - 1) permutes
        hop_wall = (table.n_ticks - 1) * 2.0 * hop_price

        per_layer = sum(
            local * (local - 1) * -(-numel // local) for numel in numels
        ) * wire_item
        fwd_gathers = M * n_layers * per_layer
        bwd_gathers = M * n_layers * per_layer
        gather_wall = bwd_gathers + fwd_gathers / float(depth + 1)

        compute_proxy = 2.0 * M * n_layers * sum(numels) * itemsize
        per_cell = compute_proxy / float(max(1, table.busy_cells()))
        bubble_wall = table.steady_bubble_ticks() * per_cell
        return hop_wall + gather_wall + bubble_wall

    return fn


def relayout_cost_fn(
    gshape: Sequence[int],
    itemsize: int,
    src_split: Optional[int],
    dst_split: Optional[int],
    nproc: int,
    *,
    budget: Optional[int] = None,
    measured_need: Optional[int] = None,
) -> ConfigCost:
    """Analytic cost of one relayout signature under a candidate config:
    the plan the candidate's ``HEAT_TPU_RELAYOUT_PLAN`` would select
    (``budget``/``measured_need`` in the planner's own convention),
    priced in wire bytes at the candidate's collective precision.
    Candidates whose per-rank temporary exceeds the budget are infeasible
    (``inf``)."""
    # lazy imports: cost.py is imported with the package and must not drag
    # core in at module load
    from ..core import relayout_planner as planner
    from ..telemetry import collectives as model

    gshape = tuple(int(s) for s in gshape)

    def fn(config: Dict[str, str]) -> float:
        from ..core import topology

        plan_mode = (config.get("HEAT_TPU_RELAYOUT_PLAN") or "auto").strip()
        prec = (config.get("HEAT_TPU_COLLECTIVE_PREC") or "off").strip()
        try:
            block = int(config.get("HEAT_TPU_COLLECTIVE_PREC_BLOCK") or 0)
        except ValueError:
            block = 0
        block = block if block > 0 else model.DEFAULT_WIRE_BLOCK
        pl = planner.plan(
            gshape, itemsize, src_split, dst_split, nproc,
            budget=budget, measured_need=measured_need,
            plan_mode=plan_mode,
        )
        if budget is not None and pl.temp_bytes > budget:
            return math.inf
        # topology-aware pricing, armed ONLY when the lattice
        # searches HEAT_TPU_HIERARCHICAL (every config of such a lattice
        # carries the key): on a non-trivial (node x local)
        # factorization, a FLAT collective's single replica group spans
        # nodes, so its whole volume is DCN-priced; the tiered
        # all-to-all charges only its cross-node stage at the premium.
        # This is what lets the analytic stage pick tiered vs flat per
        # signature before anything is measured. Lattices that do not
        # search the knob keep the historic plain-byte pricing exactly.
        searching_hier = "HEAT_TPU_HIERARCHICAL" in config
        hier_on = (config.get("HEAT_TPU_HIERARCHICAL") or "0").strip() in (
            "1", "true", "yes", "on",
        )
        topo = topology.resolve(nproc)
        tiered = hier_on and topo.nontrivial
        if getattr(pl, "stages", None):
            costs = [
                model.relayout_chunk_cost(
                    gshape, itemsize, src_split, dst_split,
                    s.hi - s.lo, nproc, precision=prec, block=block,
                )
                for s in pl.stages
            ]
        elif pl.kind == "alltoall" and tiered:
            phys_numel = 1
            for d, s_ in enumerate(gshape):
                s_ = int(s_)
                if d in (src_split, dst_split):
                    s_ = -(-s_ // nproc) * nproc
                phys_numel *= s_
            # cross tier priced at the config's COLLECTIVE_PREC: the
            # relayout program resolves its wire mode explicitly per
            # call, so the HIERARCHICAL_PREC fallback never reaches it —
            # pricing it here would reward a compression the executed
            # program cannot deliver
            costs = [
                model.hierarchical_a2a_cost(
                    phys_numel, itemsize, topo.node, topo.local,
                    prec, block=block,
                )
            ]
        else:
            costs = [
                model.relayout_cost(
                    gshape, itemsize, src_split, dst_split, nproc,
                    precision=prec, block=block,
                )
            ]
        if not searching_hier:
            return float(sum(c.bytes for c in costs))
        try:
            premium = float(config.get("HEAT_TPU_DCN_PREMIUM") or 0)
        except ValueError:
            premium = 0.0
        if premium <= 0:
            premium = None  # weighted_wire falls back to the live knob
        total = 0.0
        for c in costs:
            if topo.nontrivial and not c.dcn_bytes and c.bytes:
                # flat lowering on a 2-level topology: all bytes ride DCN
                c = model.CollectiveCost(
                    c.kind, c.bytes, steps=c.steps, dcn_bytes=c.bytes
                )
            total += model.weighted_wire(c, premium)
        return float(total)

    return fn
