"""Static pipeline schedule tables (the port's copy of
``heat_tpu/parallel/schedule.py``: pure Python, kept the same table).

A pipeline schedule is a STATIC per-tick action table: for every tick
``t`` and stage ``s`` it names the one action the stage performs —
``F(m)`` (forward of microbatch ``m``), ``B(m)`` (backward of
microbatch ``m``), or idle. The table is computed in plain Python from
``(schedule, S, M)``, and every rank of
:func:`heat_tpu_torch.parallel.pipeline.pipeline_step_program` walks the
same table tick by tick, so every send has its matching receive. The same
table drives the bubble accounting and the per-tick telemetry events, so
the analytic and measured bubble figures share one source of truth.

Two schedules (``HEAT_TPU_PIPELINE_SCHEDULE``):

``gpipe`` (default — bit-compat with the historical kernel lineage)
    All-forward wave (``S + M - 1`` ticks), a full pipeline flush, then
    the mirrored all-backward wave — the flush means every stage
    stashes all ``M`` in-flight input activations and the drain of the
    forward wave never overlaps the fill of the backward wave.

``1f1b``
    PipeDream-flush one-forward-one-backward: stage ``s`` warms up with
    at most ``min(M, S-1-s)`` forwards, then strictly alternates
    backward-priority, bounded by ``min(M, S-s)`` in-flight
    microbatches. Bit-identical results (each stage still runs its
    backwards in increasing microbatch order, so every accumulation
    order matches gpipe) while the activation stash shrinks from ``M``
    to ``min(S, M)`` and the steady-state bubble cells drop strictly
    below gpipe's whenever ``M > 1`` and ``S > 2``.

Both tables share the same makespan lower bound ``2(S + M - 1)`` — the
classical result that 1F1B's win over GPipe is memory plus the
steady-state bubble structure, not end-to-end ticks. The accounting
here is therefore explicit about WHICH cells it counts (see
:meth:`ScheduleTable.steady_bubble_ticks`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

from .. import _knobs as knobs

__all__ = [
    "Action",
    "ScheduleTable",
    "StageMapping",
    "build_schedule",
    "gpipe_schedule",
    "one_f1b_schedule",
    "plan_stages",
    "resolve_schedule_name",
]

SCHEDULES = ("gpipe", "1f1b")


@dataclass(frozen=True)
class Action:
    """One cell of the table: ``kind`` is ``"F"`` or ``"B"``, ``mb`` the
    microbatch index."""

    kind: str
    mb: int

    def __str__(self) -> str:  # pragma: no cover - debug/doc helper
        return f"{self.kind}{self.mb}"


@dataclass(frozen=True)
class ScheduleTable:
    """A fully-resolved static schedule: ``ticks[t][s]`` is the Action
    stage ``s`` performs at tick ``t`` (or None)."""

    name: str
    n_stages: int
    n_microbatches: int
    train: bool
    ticks: Tuple[Tuple[Optional[Action], ...], ...]

    # -- structural views ----------------------------------------------------

    @property
    def n_ticks(self) -> int:
        return len(self.ticks)

    def action_arrays(self) -> Tuple[List[List[int]], List[List[int]]]:
        """``(fwd, bwd)`` integer lookup tables, each ``(T, S)`` with the
        microbatch index or ``-1`` — the constants the kernel bakes in."""
        fwd = [[-1] * self.n_stages for _ in range(self.n_ticks)]
        bwd = [[-1] * self.n_stages for _ in range(self.n_ticks)]
        for t, row in enumerate(self.ticks):
            for s, act in enumerate(row):
                if act is None:
                    continue
                (fwd if act.kind == "F" else bwd)[t][s] = act.mb
        return fwd, bwd

    def describe(self) -> str:
        """ASCII timeline (stages as rows) — the doc/golden-test view."""
        lines = []
        for s in range(self.n_stages):
            cells = []
            for t in range(self.n_ticks):
                act = self.ticks[t][s]
                cells.append("...." if act is None else f"{act!s:<4}")
            lines.append(f"s{s}: " + " ".join(c.rstrip() for c in cells))
        return "\n".join(lines)

    # -- accounting ----------------------------------------------------------

    def busy_cells(self) -> int:
        return sum(1 for row in self.ticks for a in row if a is not None)

    def bubble_cells(self) -> int:
        """Idle ``(tick, stage)`` cells over the whole table."""
        return self.n_ticks * self.n_stages - self.busy_cells()

    def bubble_fraction(self) -> float:
        return self.bubble_cells() / float(self.n_ticks * self.n_stages)

    def _stage_spans(self) -> List[Tuple[int, int]]:
        spans = []
        for s in range(self.n_stages):
            busy = [
                t for t in range(self.n_ticks) if self.ticks[t][s] is not None
            ]
            spans.append((busy[0], busy[-1]))
        return spans

    def steady_window(self) -> Tuple[int, int]:
        """``(lo, hi)`` inclusive tick range in which EVERY stage has
        started and no stage has finished — the globally-active window.
        Ticks before ``lo`` are the warmup ramp, ticks after ``hi`` the
        cooldown drain; both are unavoidable fill/drain cells shared by
        every schedule at the same ``(S, M)``."""
        spans = self._stage_spans()
        return max(lo for lo, _ in spans), min(hi for _, hi in spans)

    def steady_bubble_ticks(self) -> int:
        """Idle cells inside :meth:`steady_window` — the schedule-shaped
        bubble (GPipe's flush barrier lands here; 1F1B's steady
        alternation keeps more of the window busy). This is the figure
        1f1b keeps strictly lower than gpipe at ``S=4, M=8``, and the
        per-tick telemetry events re-measure."""
        lo, hi = self.steady_window()
        idle = 0
        for t in range(lo, hi + 1):
            idle += sum(1 for a in self.ticks[t] if a is None)
        return idle

    def phase_of(self, t: int) -> str:
        lo, hi = self.steady_window()
        if t < lo:
            return "warmup"
        if t > hi:
            return "cooldown"
        return "steady"

    def stash_depth(self) -> int:
        """Max in-flight microbatches any stage holds at once (forwarded
        but not yet backwarded) — the static size of the kernel's input-
        activation stash buffer. ``M`` for gpipe, ``min(S, M)`` for 1f1b
        (forward-only tables need exactly 1: the input is consumed the
        same tick)."""
        if not self.train:
            return 1
        worst = 1
        for s in range(self.n_stages):
            inflight = 0
            for t in range(self.n_ticks):
                act = self.ticks[t][s]
                if act is None:
                    continue
                inflight += 1 if act.kind == "F" else -1
                worst = max(worst, inflight)
        return worst

    # -- validation ----------------------------------------------------------

    def validate(self) -> "ScheduleTable":
        """Check the causal contract the kernel relies on: stage ``s``
        forwards microbatch ``m`` only after stage ``s-1`` did (at least
        one tick earlier — hops deliver next tick), backwards it only
        after its own forward and (for non-last stages) after stage
        ``s+1``'s backward, and every stage runs its forwards AND
        backwards in increasing microbatch order (the accumulation-order
        invariant behind cross-schedule bit-identity)."""
        S, M = self.n_stages, self.n_microbatches
        ftick = [[None] * M for _ in range(S)]
        btick = [[None] * M for _ in range(S)]
        for t, row in enumerate(self.ticks):
            for s, act in enumerate(row):
                if act is None:
                    continue
                tab = ftick if act.kind == "F" else btick
                if tab[s][act.mb] is not None:
                    raise ValueError(
                        f"{self.name}: duplicate {act} at stage {s}"
                    )
                tab[s][act.mb] = t
        for s in range(S):
            f_order = [ftick[s][m] for m in range(M)]
            if any(x is None for x in f_order) or f_order != sorted(f_order):
                raise ValueError(
                    f"{self.name}: stage {s} forward order broken: {f_order}"
                )
            for m in range(M):
                if s > 0 and ftick[s][m] <= ftick[s - 1][m]:
                    raise ValueError(
                        f"{self.name}: F{m} at stage {s} before the "
                        f"stage-{s - 1} hop could deliver it"
                    )
            if not self.train:
                continue
            b_order = [btick[s][m] for m in range(M)]
            if any(x is None for x in b_order) or b_order != sorted(b_order):
                raise ValueError(
                    f"{self.name}: stage {s} backward order broken: {b_order}"
                )
            for m in range(M):
                if btick[s][m] <= ftick[s][m]:
                    raise ValueError(
                        f"{self.name}: B{m} at stage {s} before its forward"
                    )
                if s < S - 1 and btick[s][m] <= btick[s + 1][m]:
                    raise ValueError(
                        f"{self.name}: B{m} at stage {s} before the "
                        f"stage-{s + 1} cotangent hop could deliver it"
                    )
        return self


def gpipe_schedule(
    n_stages: int, n_microbatches: int, train: bool = True
) -> ScheduleTable:
    """The flush-barrier GPipe table: forward wave, full drain, mirrored
    backward wave (microbatches in increasing order both ways)."""
    S, M = int(n_stages), int(n_microbatches)
    _check_sm(S, M)
    wave = S + M - 1
    ticks: List[Tuple[Optional[Action], ...]] = []
    for t in range(wave):
        ticks.append(
            tuple(
                Action("F", t - s) if 0 <= t - s < M else None
                for s in range(S)
            )
        )
    if train:
        for u in range(wave):
            ticks.append(
                tuple(
                    Action("B", u - (S - 1 - s))
                    if 0 <= u - (S - 1 - s) < M
                    else None
                    for s in range(S)
                )
            )
    return ScheduleTable(
        "gpipe", S, M, train, tuple(ticks)
    ).validate()


def one_f1b_schedule(n_stages: int, n_microbatches: int) -> ScheduleTable:
    """The PipeDream-flush 1F1B table, built by event simulation: each
    stage greedily prefers a ready backward, falls back to a ready
    forward, and caps in-flight microbatches at ``min(M, S - s)`` (the
    cap is what creates the warmup/steady/cooldown phase structure)."""
    S, M = int(n_stages), int(n_microbatches)
    _check_sm(S, M)
    cap = [min(M, S - s) for s in range(S)]
    next_f = [0] * S        # next microbatch to forward
    next_b = [0] * S        # next microbatch to backward
    # messages in flight: (arrival_tick-sorted) microbatches whose input /
    # cotangent has ARRIVED at the stage (hops deliver next tick)
    f_ready = [set() for _ in range(S)]   # stages 1.. : fwd inputs
    b_ready = [set() for _ in range(S)]   # stages ..S-2 : cotangents
    f_done_last: set = set()              # last stage: own fwd completions
    ticks: List[Tuple[Optional[Action], ...]] = []
    guard = 4 * (S + M) + 8
    while (min(next_b) < M) and len(ticks) < guard:
        row: List[Optional[Action]] = [None] * S
        for s in range(S):
            m_b, m_f = next_b[s], next_f[s]
            can_b = m_b < m_f and (
                (m_b in f_done_last) if s == S - 1 else (m_b in b_ready[s])
            )
            can_f = (
                m_f < M
                and (m_f - m_b) < cap[s]
                and (s == 0 or m_f in f_ready[s])
            )
            if can_b:
                row[s] = Action("B", m_b)
            elif can_f:
                row[s] = Action("F", m_f)
        # commit the tick: completions become next-tick arrivals
        for s, act in enumerate(row):
            if act is None:
                continue
            if act.kind == "B":
                next_b[s] += 1
                if s > 0:
                    b_ready[s - 1].add(act.mb)
            else:
                next_f[s] += 1
                if s == S - 1:
                    f_done_last.add(act.mb)
                else:
                    f_ready[s + 1].add(act.mb)
        ticks.append(tuple(row))
    if min(next_b) < M:  # pragma: no cover - simulator invariant
        raise RuntimeError("1f1b simulation did not converge")
    return ScheduleTable(
        "1f1b", S, M, True, tuple(ticks)
    ).validate()


def resolve_schedule_name(name: Optional[str] = None) -> str:
    """Explicit argument, else the ``HEAT_TPU_PIPELINE_SCHEDULE`` knob."""
    raw = name if name is not None else knobs.get("HEAT_TPU_PIPELINE_SCHEDULE")
    raw = str(raw).lower()
    if raw not in SCHEDULES:
        raise ValueError(
            f"unknown pipeline schedule {raw!r}; expected one of {SCHEDULES}"
        )
    return raw


def build_schedule(
    n_stages: int,
    n_microbatches: int,
    name: Optional[str] = None,
    train: bool = True,
) -> ScheduleTable:
    """Build the resolved table. Forward-only requests always get the
    gpipe forward wave — without backwards the two schedules are the
    same wave, and one table keeps the forward program count at one."""
    sched = resolve_schedule_name(name)
    if not train:
        return gpipe_schedule(n_stages, n_microbatches, train=False)
    if sched == "gpipe":
        return gpipe_schedule(n_stages, n_microbatches, train=True)
    return one_f1b_schedule(n_stages, n_microbatches)


def _check_sm(S: int, M: int) -> None:
    if S < 1:
        raise ValueError(f"need at least one stage, got {S}")
    if M < 1:
        raise ValueError(f"need at least one microbatch, got {M}")


# -- stage-per-node-group placement ------------------------------------------


@dataclass(frozen=True)
class StageMapping:
    """How ``n_stages`` map onto the ``p`` ranks: stage ``s`` owns the
    ``local`` consecutive ranks ``[s*local, (s+1)*local)`` — exactly the
    `core/topology.py` node-group grammar, so with
    ``HEAT_TPU_PIPELINE_STAGES`` at its auto default the stages ARE the
    node groups and every inter-stage hop crosses the node tier. The
    ``local`` ranks inside a stage carry the FSDP tier: stage weights
    live flat-sharded ``1/local`` and are gathered in-group just in time."""

    p: int
    n_stages: int

    def __post_init__(self):
        if self.n_stages < 1 or self.p % self.n_stages:
            raise ValueError(
                f"{self.n_stages} stages do not divide a {self.p}-position "
                "mesh into equal node groups"
            )

    @property
    def local(self) -> int:
        return self.p // self.n_stages

    def groups(self) -> List[List[int]]:
        """The in-stage (FSDP) groups of ranks."""
        loc = self.local
        return [
            [s * loc + l for l in range(loc)] for s in range(self.n_stages)
        ]

    def fwd_perm(self) -> List[Tuple[int, int]]:
        """The stage->stage hop: rank ``(s, l)`` sends to ``(s+1, l)``
        (full ring — the wraparound pair carries no consumed payload but
        rides the same permute, so the cost model and the collective audit
        count it too)."""
        return [(i, (i + self.local) % self.p) for i in range(self.p)]

    def bwd_perm(self) -> List[Tuple[int, int]]:
        return [(i, (i - self.local) % self.p) for i in range(self.p)]

    def describe(self) -> str:
        return f"{self.n_stages}x{self.local}"


def plan_stages(p: int, n_stages: Optional[int] = None) -> StageMapping:
    """Resolve the stage count and build the mapping.

    Explicit argument wins; else the ``HEAT_TPU_PIPELINE_STAGES`` knob
    (``0`` = auto); auto is the node count of an ACTIVE 2-level topology
    (``HEAT_TPU_HIERARCHICAL=1`` + nontrivial factorization — stages per
    node group, the MPMD placement), else one stage per position (the
    flat historical layout)."""
    if n_stages is None:
        n_stages = int(knobs.get("HEAT_TPU_PIPELINE_STAGES"))
    if n_stages == 0:
        from ..core import topology as _topo

        active = _topo.active(int(p))
        n_stages = active.node if active is not None else int(p)
    return StageMapping(int(p), int(n_stages))
