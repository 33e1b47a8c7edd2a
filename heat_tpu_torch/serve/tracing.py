"""Request tracing across the serving hops.

Counterpart of ``heat_tpu/serve/tracing.py``: the same trace context, wire
field, hop names and sampling draw, so a trace minted by a router of
either package continues in a replica of the other.

* :func:`mint` creates a :class:`TraceContext` at the ingress
  (``Router.submit``, or ``Server.submit`` in process): a process-unique
  ``trace_id`` and the minting hop as ``parent_span``. The sampling
  verdict (``HEAT_TPU_TRACE_SAMPLE``) is drawn once, there, from the trace
  id, and travels with the context.
* The context rides the request envelope as the ``trace`` field
  (:func:`heat_tpu_torch.serve.net.wire.encode_request`); a peer that does
  not know it ignores it, and the payload bytes are the same either way.
* :func:`hop` stamps each hop as a ``trace_span`` telemetry event
  (``start_ts`` on the wall clock, ``seconds``, ``trace_id``, ``parent``).

Tracing records only while telemetry records: off, each site is one flag
check; on with ``HEAT_TPU_TRACE_REQUESTS=0``, one knob read at the
ingress. Every span increments ``tracing.spans``, every sampled mint
``tracing.sampled`` beside a span with ``ingress=True``.
"""

from __future__ import annotations

import itertools
import os
import zlib
from typing import Any, List, Optional, Sequence

from .. import _knobs as knobs
from .. import telemetry

__all__ = ["HOPS", "TraceContext", "active", "from_wire", "hop", "mint", "sample_rate"]

# the hop-span names, in request order
HOPS = (
    "router.queue",    # router ingress -> a worker picked the job up
    "router.post",     # HTTP round trip to the chosen replica
    "serve.queue",     # replica ingress -> the batcher started its batch
    "serve.coalesce",  # micro-batch assembly
    "serve.pad",       # pad to the ladder bucket
    "serve.execute",   # the program's dispatch and the result's copy to the host
    "serve.reply",     # slicing results back and resolving futures
)

_COUNTER = itertools.count()


class TraceContext:
    """One request's trace identity: ``trace_id`` and the minting hop's
    name as ``parent_span`` (an unsampled request has none)."""

    __slots__ = ("trace_id", "parent_span")

    def __init__(self, trace_id: str, parent_span: str):
        self.trace_id = trace_id
        self.parent_span = parent_span

    def to_wire(self) -> dict:
        """The ``trace`` field of the request JSON."""
        return {"id": self.trace_id, "parent": self.parent_span, "sampled": True}

    def __repr__(self) -> str:
        return f"TraceContext({self.trace_id!r}, parent={self.parent_span!r})"


def active() -> bool:
    """Whether tracing records: telemetry on and ``HEAT_TPU_TRACE_REQUESTS``
    not off."""
    return telemetry.enabled() and bool(knobs.get("HEAT_TPU_TRACE_REQUESTS"))


def sample_rate() -> float:
    """``HEAT_TPU_TRACE_SAMPLE`` clamped to [0, 1]."""
    return min(1.0, max(0.0, float(knobs.get("HEAT_TPU_TRACE_SAMPLE"))))


def _sampled(trace_id: str, rate: float) -> bool:
    # deterministic in the trace id (the JAX package's draw)
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    return (zlib.crc32(trace_id.encode("ascii")) % 1_000_000) < rate * 1e6


def mint(origin: str) -> Optional[TraceContext]:
    """A context at an ingress hop, or None when tracing is off or the
    draw said no; each minted context increments ``tracing.sampled``."""
    if not active():
        return None
    trace_id = f"{os.getpid():08x}{next(_COUNTER) & 0xFFFFFFFF:08x}"
    if not _sampled(trace_id, sample_rate()):
        return None
    telemetry.get_registry().add("tracing.sampled", 1)
    return TraceContext(trace_id, origin)


def from_wire(obj: Any) -> Optional[TraceContext]:
    """Adopt an upstream ``trace`` field, or None (absent, malformed, or
    tracing off here: the local switch wins)."""
    if not isinstance(obj, dict) or not obj.get("sampled"):
        return None
    if not active():
        return None
    trace_id = obj.get("id")
    if not isinstance(trace_id, str) or not trace_id:
        return None
    parent = obj.get("parent")
    return TraceContext(trace_id, parent if isinstance(parent, str) else "remote")


def hop(name: str, ctxs: Sequence[TraceContext], start_ts: float, seconds: float, *,
        ingress: bool = False, **fields: Any) -> None:
    """One hop span on the telemetry stream for every sampled context of
    ``ctxs`` (a batch hop carries the first ``trace_id`` and the whole
    ``trace_ids`` list)."""
    ctxs = [c for c in ctxs if c is not None]
    if not ctxs:
        return
    reg = telemetry.get_registry()
    reg.add("tracing.spans", 1)
    primary = ctxs[0]
    if len(ctxs) > 1:
        fields["trace_ids"] = [c.trace_id for c in ctxs]
    if ingress:
        fields["ingress"] = True
    reg.emit("trace_span", name, seconds=float(seconds), start_ts=float(start_ts),
             trace_id=primary.trace_id, parent=primary.parent_span, **fields)


def span_trace_ids(ev: dict) -> List[str]:
    """Every trace id a ``trace_span`` event carries."""
    out = []
    tid = ev.get("trace_id")
    if tid:
        out.append(tid)
    for t in ev.get("trace_ids") or ():
        if t not in out:
            out.append(t)
    return out
