"""The telemetry names of the network serving tier.

Counterpart of ``heat_tpu/serve/net/events.py``, with the same names:
every ``serve_net`` event increments exactly one counter
(``serve_net.<name>``) beside its emission, so a live summary of the
counters and an offline replay of the events agree. ``EVENT_COUNTER`` is
that event-name to counter-name map.
"""

from __future__ import annotations

from typing import Any

from ... import telemetry

__all__ = ["EVENT_COUNTER", "emit"]

# event (on the wire / in the sink)  ->  counter suffix (live registry)
EVENT_COUNTER = {
    "route": "requests",         # one successfully routed request
    "retry": "retries",          # sibling retry after a 503/connect-refused
    "evict": "evictions",        # replica marked down, out of rotation
    "readd": "readds",           # health probe brought a replica back
    "failed": "failed",          # request failed after the retry ladder
    "shed": "shed",              # every replica shed (503 to the client)
    "spawn": "replicas_spawned",  # pool started a replica process
    "remove": "replicas_removed",  # drain-then-kill removal completed
    "kill": "replicas_killed",   # hard kill (chaos)
    "listen": "listens",         # HTTP front bound its port
    "drain": "drains",           # graceful drain began
    "slo_burn": "slo_burns",     # SLO burn rate crossed threshold
    # -- the control plane, priority classes and hedging --------------------
    "spawn_fail": "spawn_fails",  # replica died during warmup, reaped
    "suspect": "suspects",       # ops scrape failed after retry: target
    #                              flagged suspect (never a silent None)
    "detach": "detaches",        # target administratively removed from
    #                              rotation (scale-down / replacement)
    "priority_shed": "priority_sheds",  # weighted-fair admission shed the
    #                              lowest-priority queued (or incoming) job
    "hedge": "hedges",           # duplicate dispatch launched for a
    #                              straggling in-flight request
    "hedge_win": "hedge_wins",   # the hedge arm answered first (loser
    #                              canceled by closing its connection)
}


def emit(name: str, event: str, **fields: Any) -> None:
    """Emit one ``serve_net`` instant event + its paired counter (no-op
    while telemetry is disabled — one flag check)."""
    if not telemetry.enabled():
        return
    reg = telemetry.get_registry()
    reg.add(f"serve_net.{EVENT_COUNTER[event]}", 1)
    reg.emit("serve_net", name, event=event, **fields)
