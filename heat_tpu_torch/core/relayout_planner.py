"""Communication-aware relayout planning.

Counterpart of ``heat_tpu/core/relayout_planner.py``. A resplit between two
split axes is one ``all_to_all`` (``DNDarray.resplit``): the right call
when it fits, but near the memory ceiling its temporaries break first. Any
resplit decomposes into chains of smaller collectives with bounded peak
memory (arXiv:2112.01075); this module chooses and runs such a chain:

* :func:`plan` chooses among

  - **monolithic**: the communicator's one ``all_to_all``
    (``TorchCommunication.all_to_all``), today's ``resplit`` bit for bit;
  - **alltoall**: the same exchange issued as its own audited stage
    (site ``relayout_a2a``), the plan to force when one pinned collective
    is wanted;
  - **chunked**: ``k`` destination-shard-aligned blocks of the destination
    axis, each moved by one all-gather of the block (every rank's source
    rows of those columns, stacked; the owner keeps the block). Peak
    temporaries are ``O(B/k)`` instead of ``O(B)``; the wire is
    ``~B·(p-1)`` against the all-to-all's ``B·(p-1)/p``, so ``auto`` takes
    it only when monolithic does not fit.

* the temporary-memory model is the JAX package's analytic one
  (``_MONO_TEMP_FACTOR``, ``_CHUNK_TEMP_FACTOR``), so both packages choose
  the same plan for the same inputs; feasibility is
  ``memory_guard.preflight``'s arithmetic (``live + need <= budget`` under
  ``HEAT_TPU_HBM_BUDGET``). A chunk stage here holds this rank's padded
  block and the stacked gather, ``(1 + 1/p)`` of a chunk, inside the
  model's ``1.5`` for ``p >= 2``.

* :func:`run` executes a decomposed plan stage by stage; ``audit=True``
  records each stage's collectives against its analytic cost
  (``telemetry.collectives.relayout_chunk_cost``, site ``relayout_stage``),
  and the whole relayout is then not audited a second time.

``HEAT_TPU_RELAYOUT_PLAN=auto|monolithic|chunked|alltoall`` (default
``auto``: no budget never plans, so ``resplit`` pays one knob read and one
budget read). The planner plans the exact relayout; a compressed wire
(``manipulations.resplit(precision=)``) keeps ``collective_prec.reshard``.
The sparse ``transpose`` sizes its stages from the same budget
(:func:`sparse_slab`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence, Tuple

import torch

from .. import _knobs as knobs
from .. import telemetry
from .communication import ring_overlap  # noqa: F401  (the ring sites read it here)

__all__ = [
    "MAX_CHUNKS",
    "PlanStage",
    "RelayoutPlan",
    "active",
    "bench_field",
    "chunk_stage_need",
    "maybe_plan",
    "mode",
    "monolithic_need",
    "plan",
    "plan_memory",
    "ring_overlap",
    "run",
    "sparse_slab",
]

_MODES = ("auto", "monolithic", "chunked", "alltoall")

# hard cap on the decomposition width: k bounds the stages of one plan
MAX_CHUNKS = 32

# the JAX package's per-device temporary model (measured against XLA's
# memory analysis there, rounded up): a monolithic s->t relayout ~2x its
# per-device shard, a chunk stage ~1.5x its chunk
_MONO_TEMP_FACTOR = 2.0
_CHUNK_TEMP_FACTOR = 1.5


def mode() -> str:
    """The active ``HEAT_TPU_RELAYOUT_PLAN`` value (malformed: ``auto``)."""
    raw = (knobs.raw("HEAT_TPU_RELAYOUT_PLAN", "") or "").strip().lower()
    return raw if raw in _MODES else "auto"


@dataclass(frozen=True)
class PlanStage:
    """One chunk stage: destination-axis block ``[lo, hi)`` with its
    analytic collective cost and per-device temporary estimate."""

    lo: int
    hi: int
    cost: "telemetry.collectives.CollectiveCost"
    temp_bytes: int

    def summary(self) -> dict:
        return {"lo": self.lo, "hi": self.hi, "collective": self.cost.kind,
                "wire_bytes": self.cost.bytes, "temp_bytes": self.temp_bytes}


@dataclass(frozen=True)
class RelayoutPlan:
    """The selected relayout schedule for one layout signature."""

    kind: str                       # "monolithic" | "alltoall" | "chunked"
    gshape: Tuple[int, ...]
    itemsize: int
    src_split: Optional[int]
    dst_split: Optional[int]
    chunk_axis: Optional[int]       # destination axis the chunks tile
    stages: Tuple[PlanStage, ...]   # empty for monolithic/alltoall
    predicted_bytes: int            # total wire bytes over all stages
    temp_bytes: int                 # analytic peak per-device temporaries
    reason: str                     # why this plan won

    @property
    def chunks(self) -> int:
        return len(self.stages)

    def summary(self) -> dict:
        """The ``relayout_plan`` telemetry event's payload."""
        return {"plan": self.kind, "gshape": list(self.gshape), "src_split": self.src_split,
                "dst_split": self.dst_split, "chunks": self.chunks,
                "stages": self.chunks if self.kind == "chunked" else 1,
                "predicted_bytes": self.predicted_bytes, "temp_bytes": self.temp_bytes,
                "reason": self.reason}


def _phys_numel(gshape: Sequence[int], split: Optional[int], nproc: int) -> int:
    """Elements of the array with its split axis rounded up to ``ceil(n/p)*p``."""
    n = 1
    for d, s in enumerate(gshape):
        if d == split:
            s = -(-int(s) // nproc) * nproc
        n *= int(s)
    return n


def monolithic_need(gshape: Sequence[int], itemsize: int, src_split: Optional[int],
                    dst_split: Optional[int], nproc: int) -> int:
    """Analytic per-device (temporaries + output) bytes of the monolithic
    relayout, what the budget is held against. A replicated destination
    holds the whole output on every device."""
    if nproc <= 1 or src_split == dst_split:
        return 0
    b_src = _phys_numel(gshape, src_split, nproc) * int(itemsize)
    b_dst = _phys_numel(gshape, dst_split, nproc) * int(itemsize)
    out = b_dst if dst_split is None else b_dst // nproc
    if src_split is None or dst_split is None:
        return out  # a local slice, or an all-gather whose output dominates
    return int(_MONO_TEMP_FACTOR * b_src / nproc) + out


def chunk_stage_need(gshape: Sequence[int], itemsize: int, src_split: int, dst_split: int,
                     width: int, nproc: int) -> Tuple[int, int]:
    """(per-device temporaries, per-device output) bytes of one chunk stage
    of ``width`` destination-axis columns."""
    other = _phys_numel(gshape, src_split, nproc) // max(1, int(gshape[dst_split]))
    chunk = other * int(width) * int(itemsize)
    out = _phys_numel(gshape, dst_split, nproc) * int(itemsize) // nproc
    return int(_CHUNK_TEMP_FACTOR * chunk), out


def _whole(kind, gshape, itemsize, src, dst, nproc, reason) -> RelayoutPlan:
    cost = telemetry.collectives.relayout_cost(gshape, itemsize, src, dst, nproc)
    return RelayoutPlan(kind=kind, gshape=tuple(int(s) for s in gshape), itemsize=int(itemsize),
                        src_split=src, dst_split=dst, chunk_axis=None, stages=(),
                        predicted_bytes=int(cost.bytes),
                        temp_bytes=monolithic_need(gshape, itemsize, src, dst, nproc),
                        reason=reason)


def _chunked(gshape, itemsize, src, dst, nproc, width: int, reason: str) -> RelayoutPlan:
    """Destination-shard-aligned blocks of ``width`` columns along ``dst``
    (clipped at shard and logical edges), one stage a block; the widths are
    evened out within a shard, so a plan has at most two block shapes."""
    gshape = tuple(int(s) for s in gshape)
    extent = gshape[dst]
    cm = -(-extent // nproc)  # destination shard width (the ceil rule)
    width = max(1, min(int(width), cm))
    per_shard = -(-cm // width)
    width = -(-cm // per_shard)
    stages = []
    for shard in range(nproc):
        base = shard * cm
        for q in range(per_shard):
            lo = base + q * width
            hi = min(lo + width, min(base + cm, extent))
            if hi <= lo:
                continue
            cost = telemetry.collectives.relayout_chunk_cost(gshape, itemsize, src, dst, hi - lo,
                                                             nproc)
            temp, _ = chunk_stage_need(gshape, itemsize, src, dst, hi - lo, nproc)
            stages.append(PlanStage(lo=lo, hi=hi, cost=cost, temp_bytes=temp))
    return RelayoutPlan(kind="chunked", gshape=gshape, itemsize=int(itemsize), src_split=src,
                        dst_split=dst, chunk_axis=dst, stages=tuple(stages),
                        predicted_bytes=sum(int(s.cost.bytes) for s in stages),
                        temp_bytes=max((s.temp_bytes for s in stages), default=0),
                        reason=reason)


def _chunk_width_for(gshape, itemsize, src, dst, nproc, avail: int) -> int:
    """The widest chunk whose stage temporaries fit ``avail`` bytes, no
    narrower than :data:`MAX_CHUNKS` stages allow."""
    extent = int(gshape[dst])
    cm = max(1, -(-extent // nproc))
    other = _phys_numel(gshape, src, nproc) // max(1, extent)
    per_col = max(1, int(_CHUNK_TEMP_FACTOR * other * itemsize))
    width = max(1, min(cm, avail // per_col))
    min_width = -(-cm // max(1, MAX_CHUNKS // nproc))
    return max(width, min_width)


def plan(gshape: Sequence[int], itemsize: int, src_split: Optional[int],
         dst_split: Optional[int], comm, *, budget: Optional[int] = None, live: int = 0,
         measured_need: Optional[int] = None, plan_mode: Optional[str] = None) -> RelayoutPlan:
    """The relayout plan for one layout signature; pure given its inputs
    (``comm`` is a communicator or a world size). ``budget``/``live`` are
    bytes in ``memory_guard``'s convention, ``measured_need`` replaces the
    analytic monolithic need, ``plan_mode`` overrides the knob.

    ``auto``: monolithic when it fits (``live + need <= budget``, or no
    budget); else chunked with the widest chunk the headroom holds; else,
    when even a one-column chunk cannot fit, monolithic, so the memory
    guard raises its own error. Only split-to-split relayouts decompose."""
    nproc = getattr(comm, "size", comm if isinstance(comm, int) else 1)
    m = plan_mode if plan_mode in _MODES else mode()
    gshape = tuple(int(s) for s in gshape)
    decomposable = (nproc > 1 and src_split is not None and dst_split is not None
                    and src_split != dst_split and gshape[dst_split] > 0
                    and all(s > 0 for s in gshape))
    if m == "monolithic" or (not decomposable and m != "auto"):
        reason = ("forced by HEAT_TPU_RELAYOUT_PLAN=monolithic" if m == "monolithic"
                  else f"{m} forced but relayout is not decomposable; monolithic")
        return _whole("monolithic", gshape, itemsize, src_split, dst_split, nproc, reason)
    if m == "alltoall":
        return _whole("alltoall", gshape, itemsize, src_split, dst_split, nproc,
                      "forced by HEAT_TPU_RELAYOUT_PLAN=alltoall")
    if m == "chunked":
        from ..resilience import memory_guard

        width = _chunk_width_for(gshape, itemsize, src_split, dst_split, nproc,
                                 memory_guard.temp_budget())
        return _chunked(gshape, itemsize, src_split, dst_split, nproc, width,
                        "forced by HEAT_TPU_RELAYOUT_PLAN=chunked")
    if budget is None or not decomposable:
        return _whole("monolithic", gshape, itemsize, src_split, dst_split, nproc,
                      "auto: no budget" if budget is None else "auto: not decomposable")
    need = (int(measured_need) if measured_need is not None and measured_need > 0
            else monolithic_need(gshape, itemsize, src_split, dst_split, nproc))
    if live + need <= budget:
        return _whole("monolithic", gshape, itemsize, src_split, dst_split, nproc,
                      f"auto: monolithic fits (live {live} + need {need} <= budget {budget})")
    temp_min, out = chunk_stage_need(gshape, itemsize, src_split, dst_split, 1, nproc)
    if live + temp_min + out > budget:
        return _whole("monolithic", gshape, itemsize, src_split, dst_split, nproc,
                      f"auto: no feasible decomposition (budget {budget} B below even a "
                      f"width-1 chunk's need, live {live} B)")
    avail = max(1, budget - live - out)
    width = _chunk_width_for(gshape, itemsize, src_split, dst_split, nproc, avail)
    return _chunked(gshape, itemsize, src_split, dst_split, nproc, width,
                    f"auto: monolithic needs {need} B over budget {budget} B (live {live} B); "
                    f"chunked width {width}")


def active() -> bool:
    """Whether planning can change anything: a knob other than ``auto``, or
    a memory budget."""
    if mode() != "auto":
        return True
    from ..resilience import memory_guard

    return memory_guard.budget_bytes() is not None


def maybe_plan(gshape, itemsize: int, src_split: Optional[int], dst_split: Optional[int],
               comm, measure: Optional[Callable[[], int]] = None) -> Optional[RelayoutPlan]:
    """``resplit``'s entry point: None on the fast path (``auto``, no
    budget, one rank, or no change of split), else the selected plan. Live
    bytes are read after a garbage collection, only when a budget decision
    needs them; ``measure()`` may supply a measured monolithic need."""
    if not active() or comm.size <= 1 or src_split == dst_split:
        return None
    from ..resilience import memory_guard

    budget = memory_guard.budget_bytes()
    measured, live = None, 0
    decomposable = (src_split is not None and dst_split is not None
                    and all(int(s) > 0 for s in gshape))
    if budget is not None and decomposable:
        if measure is not None and mode() == "auto":
            try:
                measured = measure()
            except Exception:
                measured = None
        import gc

        gc.collect()
        live = memory_guard.live_bytes()
    p = plan(gshape, itemsize, src_split, dst_split, comm, budget=budget, live=live,
             measured_need=measured)
    if telemetry.enabled():
        reg = telemetry.get_registry()
        reg.add(f"relayout_plan.{p.kind}", 1)
        reg.emit("relayout_plan", p.kind, budget=budget, live_bytes=live,
                 measured_need=measured, **p.summary())
    return p


# -- plan execution ---------------------------------------------------------------


def _a2a_predicted(plan_: RelayoutPlan, nproc: int):
    """The all-to-all stage's cost on the chunks as padded for the exchange
    (the prediction ``resplit``'s own audit makes)."""
    phys = list(plan_.gshape)
    for ax in (plan_.src_split, plan_.dst_split):
        if ax is not None:
            phys[ax] = -(-phys[ax] // nproc) * nproc
    return telemetry.collectives.relayout_cost(phys, plan_.itemsize, plan_.src_split,
                                               plan_.dst_split, nproc)


def _chunk_stage(local: torch.Tensor, plan_: RelayoutPlan, stage: PlanStage, comm,
                 acc: torch.Tensor) -> None:
    """One chunk stage: this rank's source rows of columns ``[lo, hi)``,
    padded to the source chunk size, go to every rank in one all-gather;
    the owner of the block copies each rank's rows into its accumulator."""
    src, dst = plan_.src_split, plan_.dst_split
    n_src = plan_.gshape[src]
    c_src = comm.chunk_size(n_src)
    block = local.narrow(dst, stage.lo, stage.hi - stage.lo)
    if block.shape[src] != c_src:
        shape = list(block.shape)
        shape[src] = c_src
        padded = block.new_zeros(shape)
        padded.narrow(src, 0, block.shape[src]).copy_(block)
        block = padded
    stacked = comm.gather_stack(block.contiguous(), name="all_gather")
    cm = comm.chunk_size(plan_.gshape[dst])
    owner = stage.lo // cm
    if comm.rank != owner:
        return
    counts, displs = comm.counts_displs(n_src)
    target = acc.narrow(dst, stage.lo - owner * cm, stage.hi - stage.lo)
    for r in range(comm.size):
        if counts[r]:
            target.narrow(src, displs[r], counts[r]).copy_(stacked[r].narrow(src, 0, counts[r]))


def run(plan_: RelayoutPlan, local: torch.Tensor, comm, *, audit: bool = False) -> torch.Tensor:
    """Execute a decomposed plan on this rank's source chunk ``local``;
    returns this rank's destination chunk. ``audit=True`` records every
    stage's collectives against its analytic cost (``relayout_stage``
    records in ``telemetry.hlo.recent()``)."""
    from . import program_cache

    src, dst = plan_.src_split, plan_.dst_split
    dtype = str(local.dtype)
    if plan_.kind == "alltoall":
        def a2a():
            return program_cache.cached_program(
                "relayout_a2a", (plan_.gshape, dtype, src, dst), lambda: _a2a_program,
                comm=comm, inline=True)(local, comm, plan_.gshape, src, dst)

        if audit:
            out, _ = telemetry.hlo.audit_call("relayout_stage", a2a,
                                              predicted=_a2a_predicted(plan_, comm.size),
                                              fields={"plan": "alltoall"})
            return out.contiguous()
        return a2a().contiguous()
    if plan_.kind != "chunked":
        raise ValueError(f"run() executes decomposed plans; got {plan_.kind!r} (monolithic "
                         "dispatches through DNDarray.resplit directly)")
    shape = list(local.shape)
    shape[src] = plan_.gshape[src]
    _, _, slices = comm.chunk(plan_.gshape, dst)
    shape[dst] = slices[dst].stop - slices[dst].start
    acc = program_cache.cached_program(
        "relayout_init", (tuple(shape), dtype, dst), lambda: _zeros,
        comm=comm, inline=True)(local, shape)
    for stage in plan_.stages:
        # a stage writes its block of the accumulator whole: a retry
        # rewrites the same block
        chunk = program_cache.cached_program(
            "relayout_chunk", (plan_.gshape, dtype, src, dst, stage.lo, stage.hi),
            lambda: _chunk_stage, comm=comm, inline=True)
        if audit:
            telemetry.hlo.audit_call(
                "relayout_stage", lambda stage=stage, chunk=chunk: chunk(local, plan_, stage, comm,
                                                                       acc),
                predicted=stage.cost,
                fields={"plan": "chunked", "lo": stage.lo, "hi": stage.hi})
        else:
            chunk(local, plan_, stage, comm, acc)
    return acc


def _zeros(like: torch.Tensor, shape) -> torch.Tensor:
    """The zero accumulator of a chunked plan (site ``relayout_init``)."""
    return like.new_zeros(shape)


def _a2a_program(local: torch.Tensor, comm, gshape, src: int, dst: int) -> torch.Tensor:
    """The one ``all_to_all`` of an ``alltoall`` plan (site ``relayout_a2a``)."""
    return comm.all_to_all(local, dst, src, gshape[dst], gshape[src])


def sparse_slab(cap: int, itemsize: int, nproc: int) -> int:
    """Slots a stage of the sparse ``transpose`` moves: every slot without a
    budget (one stage), else as many as fit the temporary budget
    (``memory_guard.temp_budget()``) at ``3 · p · (8 + itemsize)`` bytes a
    slot: the send and receive slabs of the 8-byte key and the value, and
    the sort's scratch (the JAX package's ``sparse/ops.py`` rule)."""
    from ..resilience import memory_guard

    if memory_guard.budget_bytes() is None:
        return max(1, int(cap))
    per_elem = 3 * int(nproc) * (8 + int(itemsize))
    return max(1, min(int(cap), memory_guard.temp_budget() // per_elem))


def bench_field(gshape: Tuple[int, ...] = (4096, 64), itemsize: int = 4, comm=None) -> dict:
    """What the active policy would do with the canonical resplit shape
    (split 0 to 1) on ``comm`` (default: the global communicator): plan,
    stages, predicted wire bytes, and the wire bytes its collectives
    report when the plan is run once under an audit."""
    from .communication import get_comm
    from ..resilience import memory_guard

    comm = comm if comm is not None else get_comm()
    budget = memory_guard.budget_bytes()
    live = memory_guard.live_bytes() if budget is not None else 0
    pl = plan(gshape, itemsize, 0, 1, comm, budget=budget, live=live)
    field = {"plan": pl.kind, "stages": pl.chunks if pl.kind == "chunked" else 1,
             "mode": mode(), "budget": budget, "ring_overlap": ring_overlap(),
             "predicted_wire_bytes": pl.predicted_bytes, "audited_wire_bytes": None}
    try:
        from . import factories, types

        x = factories.zeros(gshape, dtype=types.float32, split=0, comm=comm)
        if pl.kind in ("chunked", "alltoall"):
            _, rec = telemetry.hlo.audit_call("relayout_bench", lambda: run(pl, x.larray, comm))
        else:
            _, rec = telemetry.hlo.audit_call("relayout_bench", lambda: x.resplit(1))
        field["audited_wire_bytes"] = int(rec.audit.total_wire())
    except Exception:  # the probe never takes its caller down
        pass
    return field


def plan_memory(plan_: RelayoutPlan, local: torch.Tensor, comm) -> dict:
    """Measured peak temporaries of each stage of a decomposed plan on the
    card (``torch.cuda.max_memory_allocated`` above the bytes live before
    the stage, the accumulator included in neither): ``{"stage_temp_bytes",
    "peak_temp_bytes", "model_temp_bytes"}``; -1 where nothing is measured
    (the CPU, or a plan that is not chunked)."""
    temps = []
    if plan_.kind == "chunked" and local.is_cuda:
        shape = list(local.shape)
        shape[plan_.src_split] = plan_.gshape[plan_.src_split]
        _, _, slices = comm.chunk(plan_.gshape, plan_.dst_split)
        shape[plan_.dst_split] = slices[plan_.dst_split].stop - slices[plan_.dst_split].start
        acc = local.new_zeros(shape)
        for stage in plan_.stages:
            torch.cuda.synchronize(local.device)
            base = torch.cuda.memory_allocated(local.device)
            torch.cuda.reset_peak_memory_stats(local.device)
            _chunk_stage(local, plan_, stage, comm, acc)
            torch.cuda.synchronize(local.device)
            temps.append(int(torch.cuda.max_memory_allocated(local.device) - base))
    else:
        temps.append(-1)
    measured = [t for t in temps if t >= 0]
    return {"stage_temp_bytes": temps, "peak_temp_bytes": max(measured) if measured else -1,
            "model_temp_bytes": plan_.temp_bytes}
