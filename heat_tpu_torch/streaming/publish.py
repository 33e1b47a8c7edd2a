"""Roll a new checkpoint through a pool of serving replicas.

Counterpart of ``heat_tpu/streaming/publish.py`` (:42-107 there). A
replica process is born from one checkpoint and serves that version for
its whole life, so rolling a pool replaces one replica at a time: spawn a
replacement from the new checkpoint, hand it to the router, then drain and
remove one old replica. Capacity never drops below the starting count.

:func:`rolling_update` is duck-typed over ``pool`` (``set_checkpoint``,
``replicas`` with ``index``/``state``/``alive()``, ``spawn``, ``remove``,
``handle``, ``stats``) and ``router`` (``add_target``); the port's
``ReplicaPool`` and router come with the serving tier (ROADMAP §1 item 14).
"""

from __future__ import annotations

import time
from typing import Optional

from .. import _knobs as knobs
from . import events

__all__ = ["rolling_update"]


def rolling_update(pool, router, checkpoint: str, *, drain_timeout: Optional[float] = None,
                   ready_probe: bool = True) -> dict:
    """Roll every live replica of ``pool`` onto ``checkpoint``, one at a
    time: ``spawn(new) -> router.add_target(new) -> remove(old)`` (drain,
    then stop; the pool reports the exit code, which must be 0).

    Returns ``{"steps": [...], "replicas", "seconds", "versions"}``, where
    ``versions`` maps each live replica's index to the endpoint versions its
    ``stats`` report after the roll. ``drain_timeout`` defaults to
    ``HEAT_TPU_STREAM_DRAIN_TIMEOUT``: how long an old replica may take to
    finish its backlog before the roll fails loudly."""
    if drain_timeout is None:
        drain_timeout = float(knobs.get("HEAT_TPU_STREAM_DRAIN_TIMEOUT"))
    t_start = time.perf_counter()
    pool.set_checkpoint(checkpoint)
    old = [h.index for h in list(pool.replicas) if h.state == "up" and h.alive()]
    if not old:
        raise RuntimeError("rolling_update: pool has no live replicas")
    steps = []
    for idx in old:
        t0 = time.perf_counter()
        repl = pool.spawn()  # born from the new checkpoint
        router.add_target(repl.url)
        rc = pool.remove(idx, timeout=drain_timeout)
        step = {"replaced": idx, "replacement": repl.index, "drain_rc": rc,
                "seconds": round(time.perf_counter() - t0, 3)}
        steps.append(step)
        events.emit("pool", "roll_step", **step)
        if rc != 0:
            raise RuntimeError(f"rolling_update: replica {idx} exited rc={rc} during drain "
                               f"(log: {pool.handle(idx).log_path})")
    versions = {}
    if ready_probe:
        for h in list(pool.replicas):
            if h.state == "up" and h.alive():
                try:
                    versions[h.index] = pool.stats(h.index).get("versions") or {}
                except Exception as e:  # noqa: BLE001 - a dead replica is data
                    versions[h.index] = {"error": repr(e)}
    return {"steps": steps, "replicas": len(old),
            "seconds": round(time.perf_counter() - t_start, 3), "versions": versions}
