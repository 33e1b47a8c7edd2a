"""The telemetry names of the streaming estimators.

Counterpart of ``heat_tpu/streaming/events.py`` (:27-46 there), with the
same event and counter names: every ``streaming`` event increments one
counter ``streaming.<name>`` beside its emission, and a ``stream_chunk``
event also adds its ``rows`` to ``streaming.rows`` (the rows/s numerator).
"""

from __future__ import annotations

from typing import Any

from .. import telemetry

__all__ = ["EVENT_COUNTER", "emit"]

# event (on the wire / in the sink) -> counter suffix (live registry)
EVENT_COUNTER = {
    "stream_chunk": "chunks",         # one out-of-core chunk ingested
    "version_swap": "version_swaps",  # in-process versioned publish
    "roll_step": "roll_steps",        # one replica replaced in a rolling update
    "checkpoint": "checkpoints",      # estimator carry checkpointed
    "resume": "resumes",              # estimator carry restored mid-stream
}


def emit(name: str, event: str, **fields: Any) -> None:
    """One ``streaming`` event and its counter; a no-op while telemetry is
    disabled."""
    if not telemetry.enabled():
        return
    reg = telemetry.get_registry()
    reg.add(f"streaming.{EVENT_COUNTER[event]}", 1)
    if event == "stream_chunk" and fields.get("rows"):
        reg.add("streaming.rows", int(fields["rows"]))
    reg.emit("streaming", name, event=event, **fields)
