"""Collective audit: the collectives the port issued against the cost model.

Counterpart of ``heat_tpu/telemetry/hlo.py``. The JAX package compiles a
program and parses the collectives XLA emitted out of its HLO text. The port
has no HLO: it issues every collective itself, through
:class:`~heat_tpu_torch.core.communication.TorchCommunication`, and each
one reports itself to :func:`heat_tpu_torch.telemetry.trace_event` with its
op, the bytes in and out on this rank and the group size. So an audit here
*runs* the call: :func:`audit_call` opens a recording on this thread, runs
``fn``, and turns every collective it issued into an
:class:`EmittedCollective`, with the JAX package's opcode names and its
wire-byte rules (``_wire_bytes``, :213-226 there; ``g`` participants a
group, ``n`` in all, per-participant bytes; ``n`` is the ``participants``
a collective reports, the ranks of every group of a tier that issue it
together, else ``g``):

====================  ===================================================
op                    total wire bytes of one call
====================  ===================================================
all-gather            ``out · (g-1)/g · n``
all-to-all            ``in · (g-1)/g · n``; for the uneven exchanges
                      (``alltoallv``) this rank's bytes sent to other
                      ranks times ``n``
reduce-scatter        ``in · (g-1)/g · n``
all-reduce            ``2 · in · (g-1)/g · n``
collective-permute    ``in · |pairs that cross ranks|``
broadcast             ``in · (g-1)`` (the port's ``bcast``; no JAX opcode)
====================  ===================================================

Each rank records what it issued and counts it for the whole group as the
JAX package's model does (every participant moving as much as this one);
the ranks' chunks differ by at most one row of padding, which every
collective here sends anyway.

:func:`compare` flags **drift** against the analytic
:class:`~.collectives.CollectiveCost` with the JAX package's verdicts and
tolerance: a missing collective, an unexpected one, or wire bytes off by
more than ``HEAT_TPU_HLO_TOLERANCE`` (10%). One difference: the record
holds every execution (a ring of ``p - 1`` hops is ``p - 1``
collective-permutes), so ``compare`` does not scale the permutes by the
predicted steps as the JAX package must for a loop body it sees once.

Host exchanges of Python objects (``allgather_object``: shapes and
counts, which the JAX package knows statically) are counted by
:func:`~heat_tpu_torch.telemetry.trace_event` but not audited.

Auditing is opt-in: ``audit=True`` on ``resplit``, ``qr``, the ring
``cdist``/``rbf``/``manhattan`` and the sparse products and transpose, or
:func:`enable_audit` / ``HEAT_TPU_HLO_AUDIT=1`` for every such site. The
record lands in :func:`recent`/:func:`last_audit` and, while telemetry
records, as an ``hlo_audit`` event that :func:`..report.summarize` folds
into its ``hlo_collectives`` block. ``parse_hlo``, ``audit_compiled`` and
``audit_computation`` have no counterpart: there is no compiled program
to parse.
"""

from __future__ import annotations

import threading
import warnings
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from .. import _knobs as knobs

__all__ = [
    "EmittedCollective",
    "CollectiveAudit",
    "Drift",
    "DriftReport",
    "AuditRecord",
    "compare",
    "audit_call",
    "enable_audit",
    "disable_audit",
    "audit_enabled",
    "last_audit",
    "recent",
    "clear",
    "DEFAULT_TOLERANCE",
]

# None: compare() reads HEAT_TPU_HLO_TOLERANCE (10%) at call time; a float
# set here (the audit CLI's --tolerance) takes its place
DEFAULT_TOLERANCE: Optional[float] = None


def _tolerance() -> float:
    if DEFAULT_TOLERANCE is not None:
        return float(DEFAULT_TOLERANCE)
    return float(knobs.get("HEAT_TPU_HLO_TOLERANCE"))


@dataclass(frozen=True)
class EmittedCollective:
    """One collective the port issued during an audited call."""

    op: str                                  # JAX opcode name
    name: str                                # the communication method
    dtype: Optional[str]                     # element type, e.g. "float32"
    shapes: Tuple[Tuple[int, ...], ...]      # this rank's result shape(s)
    in_bytes: int                            # per-participant operand bytes
    out_bytes: int                           # per-participant result bytes
    group_size: int                          # participants of the group
    n_participants: int                      # participants in all
    groups: Tuple                            # (source, destination) pairs of a permute
    wire_bytes: int                          # modeled total wire bytes
    op_name: str = ""                        # XLA's provenance there; unused here

    def summary(self) -> dict:
        return {
            "op": self.op,
            "name": self.name,
            "dtype": self.dtype,
            "shapes": [list(s) for s in self.shapes],
            "in_bytes": self.in_bytes,
            "out_bytes": self.out_bytes,
            "group_size": self.group_size,
            "wire_bytes": self.wire_bytes,
        }


def _wire_bytes(op: str, in_bytes: int, out_bytes: int, g: int, n: int,
                n_pairs: int) -> int:
    """The JAX package's wire-byte rule of one collective (module table)."""
    if op == "collective-permute":
        return in_bytes * n_pairs
    if g <= 1:
        return 0
    if op == "broadcast":
        return in_bytes * (g - 1)
    if op == "all-gather":
        return out_bytes * (g - 1) * n // g
    if op == "all-reduce":
        return 2 * in_bytes * (g - 1) * n // g
    # all-to-all and reduce-scatter: each participant ships the (g-1)/g of
    # its input destined elsewhere
    return in_bytes * (g - 1) * n // g


def _emitted(name: str, fields: Dict[str, Any]) -> EmittedCollective:
    op = fields["op"]
    g = int(fields.get("group_size", 1))
    in_b, out_b = int(fields.get("in_bytes", 0)), int(fields.get("out_bytes", 0))
    # the ranks of every group issuing it together: a tier's collective
    # runs in each of its groups at once, as one replica-grouped op there
    n = int(fields.get("participants", g))
    pairs = tuple(tuple(p) for p in fields.get("pairs", ()))
    if "sent_bytes" in fields:  # an uneven exchange: this rank's share, times the ranks
        wire = int(fields["sent_bytes"]) * n
    else:
        wire = _wire_bytes(op, in_b, out_b, g, n, sum(1 for s, d in pairs if s != d))
    return EmittedCollective(
        op=op, name=name, dtype=fields.get("dtype"),
        shapes=(tuple(fields.get("shape", ())),), in_bytes=in_b, out_bytes=out_b,
        group_size=g, n_participants=n, groups=pairs, wire_bytes=wire,
    )


@dataclass
class CollectiveAudit:
    """The collectives one audited call issued, in order."""

    collectives: List[EmittedCollective]
    n_devices: int = 1
    flops: Optional[float] = None
    bytes_accessed: Optional[float] = None

    def counts(self) -> Dict[str, int]:
        """Issued collectives per opcode."""
        out: Dict[str, int] = {}
        for c in self.collectives:
            out[c.op] = out.get(c.op, 0) + 1
        return out

    def wire_by_op(self) -> Dict[str, int]:
        """Modeled wire bytes per opcode, over every call issued."""
        out: Dict[str, int] = {}
        for c in self.collectives:
            out[c.op] = out.get(c.op, 0) + c.wire_bytes
        return out

    def total_wire(self) -> int:
        return sum(c.wire_bytes for c in self.collectives)

    def summary(self) -> dict:
        s = {
            "ops": self.counts(),
            "wire_bytes": self.wire_by_op(),
            "instructions": [c.summary() for c in self.collectives],
            "n_devices": self.n_devices,
        }
        if self.flops is not None:
            s["flops"] = self.flops
        if self.bytes_accessed is not None:
            s["bytes_accessed"] = self.bytes_accessed
        return s


# -- predicted-vs-issued drift --------------------------------------------------

# analytic CollectiveCost.kind (possibly "+"-compound) -> expected opcode
_KIND_TO_OP = {
    "all-gather": "all-gather",
    "all-to-all": "all-to-all",
    "ppermute-ring": "collective-permute",
    "all-reduce": "all-reduce",
    "reduce-scatter": "reduce-scatter",
    "none": None,
    "local-slice": None,
}


@dataclass(frozen=True)
class Drift:
    """One predicted-vs-issued discrepancy."""

    reason: str          # "missing-collective" | "unexpected-collective"
    #                    # | "byte-drift" | "unknown-kind"
    op: str
    predicted_bytes: int
    emitted_bytes: int
    detail: str

    def summary(self) -> dict:
        return {
            "reason": self.reason,
            "op": self.op,
            "predicted_bytes": self.predicted_bytes,
            "emitted_bytes": self.emitted_bytes,
            "detail": self.detail,
        }


@dataclass
class DriftReport:
    """Outcome of one :func:`compare`: ``ok`` iff no drift was flagged."""

    ok: bool
    drifts: List[Drift]
    expected_ops: Tuple[str, ...]
    predicted_bytes: int
    emitted_bytes: int       # total over the expected ops
    tolerance: float

    def summary(self) -> dict:
        return {
            "ok": self.ok,
            "expected_ops": list(self.expected_ops),
            "predicted_bytes": self.predicted_bytes,
            "emitted_bytes": self.emitted_bytes,
            "tolerance": self.tolerance,
            "drifts": [d.summary() for d in self.drifts],
        }


def compare(
    audit: CollectiveAudit,
    predicted,
    tolerance: Optional[float] = None,
    steps: Optional[int] = None,
) -> DriftReport:
    """Diff an audit against the analytic prediction for the same call.

    ``predicted`` is a :class:`~.collectives.CollectiveCost`. Flags:

    * **missing-collective**: the predicted primitive was never issued;
    * **unexpected-collective**: an issued collective the prediction does
      not name;
    * **byte-drift**: the wire bytes over the expected ops differ from the
      predicted volume by more than ``tolerance`` (relative; default
      ``HEAT_TPU_HLO_TOLERANCE``).

    The audit holds every execution, so the permutes are not scaled by the
    predicted steps unless ``steps`` asks for it (module docstring).
    """
    tolerance = _tolerance() if tolerance is None else tolerance
    steps = 1 if steps is None else int(steps)
    expected: List[str] = []
    drifts: List[Drift] = []
    for part in predicted.kind.split("+"):
        if part not in _KIND_TO_OP:
            drifts.append(Drift("unknown-kind", part, predicted.bytes, 0,
                                f"analytic kind {part!r} has no collective mapping"))
            continue
        op = _KIND_TO_OP[part]
        if op is not None:
            expected.append(op)

    emitted_total = 0
    for op in dict.fromkeys(expected):  # unique, order-preserving
        issued = [c for c in audit.collectives if c.op == op]
        if not issued:
            drifts.append(Drift("missing-collective", op, predicted.bytes, 0,
                                f"predicted {predicted.kind!r} but the call issued no {op}"))
            continue
        wire = sum(c.wire_bytes for c in issued)
        if op == "collective-permute" and steps > 1:
            wire *= steps
        emitted_total += wire

    for c in audit.collectives:
        if c.op not in expected:
            drifts.append(Drift("unexpected-collective", c.op, 0, c.wire_bytes,
                                f"{c.name}: issued {c.op} not named by the prediction "
                                f"{predicted.kind!r}"))

    if expected and not any(d.reason == "missing-collective" for d in drifts):
        pb = int(predicted.bytes)
        if pb > 0 and abs(emitted_total - pb) > tolerance * pb:
            drifts.append(Drift("byte-drift", "+".join(dict.fromkeys(expected)), pb,
                                emitted_total,
                                f"issued {emitted_total} wire bytes vs predicted {pb} "
                                f"(beyond {tolerance:.0%} tolerance)"))

    return DriftReport(
        ok=not drifts,
        drifts=drifts,
        expected_ops=tuple(dict.fromkeys(expected)),
        predicted_bytes=int(predicted.bytes),
        emitted_bytes=emitted_total,
        tolerance=tolerance,
    )


# -- recording the collectives of a call ------------------------------------------

_AUDIT_ENABLED = False
# open recordings of all threads (the one-check fast path of trace_event);
# each thread appends only to its own stack
_RECORDING = 0
_RECORDING_LOCK = threading.Lock()
_LOCAL = threading.local()
_RECENT: "deque[AuditRecord]" = deque(maxlen=64)


def _stack() -> list:
    s = getattr(_LOCAL, "stack", None)
    if s is None:
        s = _LOCAL.stack = []
    return s


def _observe(name: str, fields: Dict[str, Any]) -> None:
    """Called by ``trace_event`` for every collective while any recording
    is open: the collective goes to each open recording of this thread
    (an audit nested in another is seen by both)."""
    if "op" not in fields:  # an object exchange: counted, not audited
        return
    stack = _stack()
    if stack:
        rec = _emitted(name, fields)
        for lst in stack:
            lst.append(rec)


@dataclass
class AuditRecord:
    """One recorded audit at an instrumented site."""

    site: str
    audit: CollectiveAudit
    report: Optional[DriftReport] = None
    fields: Dict[str, Any] = field(default_factory=dict)

    def summary(self) -> dict:
        s = {"site": self.site, **self.fields}
        s["audit"] = self.audit.summary()
        s["report"] = self.report.summary() if self.report else None
        return s


def audit_enabled() -> bool:
    """Whether the global opt-in (``HEAT_TPU_HLO_AUDIT=1`` /
    :func:`enable_audit`) is active; instrumented sites also audit when
    called with ``audit=True``."""
    return _AUDIT_ENABLED


def enable_audit() -> None:
    global _AUDIT_ENABLED
    _AUDIT_ENABLED = True


def disable_audit() -> None:
    global _AUDIT_ENABLED
    _AUDIT_ENABLED = False


def clear() -> None:
    """Drop the recent-audit ring."""
    _RECENT.clear()


def recent() -> List[AuditRecord]:
    """The most recent audits (bounded ring), oldest first."""
    return list(_RECENT)


def last_audit(site: Optional[str] = None) -> Optional[AuditRecord]:
    """The most recent audit, optionally filtered by site name."""
    for rec in reversed(_RECENT):
        if site is None or rec.site == site:
            return rec
    return None


def audit_call(
    site: str,
    fn: Callable[[], Any],
    predicted=None,
    fields: Optional[Dict[str, Any]] = None,
    tolerance: Optional[float] = None,
) -> Tuple[Any, Optional[AuditRecord]]:
    """Run ``fn()`` and audit the collectives it issues on this thread:
    returns ``(fn's result, record)``. An exception of ``fn`` propagates
    (it is the workload); a failure of the bookkeeping warns and gives
    ``None`` as the record. The record lands in :func:`recent` and, while
    telemetry records, as an ``hlo_audit`` event with the issued counts and
    bytes and the drift verdict against ``predicted``."""
    global _RECORDING
    issued: List[EmittedCollective] = []
    stack = _stack()
    stack.append(issued)
    with _RECORDING_LOCK:
        _RECORDING += 1
    try:
        out = fn()
    finally:
        with _RECORDING_LOCK:
            _RECORDING -= 1
        stack.remove(issued)
    try:
        rec = _record(site, issued, predicted, fields, tolerance)
    except Exception as e:  # the auditor observes; it never takes the workload down
        warnings.warn(f"heat_tpu_torch.telemetry.hlo: audit of {site!r} failed ({e!r})")
        rec = None
    return out, rec


def _record(site, issued, predicted, fields, tolerance) -> AuditRecord:
    audit = CollectiveAudit(collectives=issued,
                            n_devices=max((c.group_size for c in issued), default=1))
    report = compare(audit, predicted, tolerance=tolerance) if predicted is not None else None
    rec = AuditRecord(site=site, audit=audit, report=report, fields=dict(fields or {}))
    _RECENT.append(rec)

    from . import enabled, get_registry

    if enabled():
        ev: Dict[str, Any] = {"ops": audit.counts(), "bytes_by_op": audit.wire_by_op()}
        if report is not None:
            ev.update(predicted=predicted.kind, predicted_bytes=int(predicted.bytes),
                      emitted_bytes=report.emitted_bytes, drift=len(report.drifts),
                      ok=report.ok)
            if report.drifts:
                ev["drifts"] = [d.summary() for d in report.drifts]
        else:
            ev["emitted_bytes"] = audit.total_wire()
        ev.update(fields or {})
        get_registry().emit("hlo_audit", site, **ev)
    return rec


if knobs.get("HEAT_TPU_HLO_AUDIT"):
    _AUDIT_ENABLED = True
