"""The SLO-driven autoscaler over a replica pool and its router.

Counterpart of ``heat_tpu/serve/net/controller.py``: the policy that
watches the router's sensors (backlog, sheds, the SLO burn of
``Router.check_slos()``) and drives the pool's actuators
(``ReplicaPool.spawn``/``remove``) so the fleet holds its SLO at the least
footprint:

* **scale-up**: an SLO burn breach scales up at once; a sustained backlog
  (per-replica backlog at or above ``HEAT_TPU_AUTOSCALE_BACKLOG_HIGH`` for
  ``HEAT_TPU_AUTOSCALE_BACKLOG_TICKS`` consecutive ticks) or fresh sheds
  after the streak. One replica an action, bounded by
  ``HEAT_TPU_AUTOSCALE_MAX`` and ``HEAT_TPU_AUTOSCALE_UP_COOLDOWN_S``;
* **scale-down**: after ``HEAT_TPU_AUTOSCALE_IDLE_TICKS`` consecutive idle
  ticks (per-replica backlog at or below ``HEAT_TPU_AUTOSCALE_IDLE_LOW``,
  no new sheds, no burn) the newest replica leaves the router first and
  then drains (``ReplicaPool.remove``'s SIGTERM), bounded by
  ``HEAT_TPU_AUTOSCALE_MIN`` and ``HEAT_TPU_AUTOSCALE_DOWN_COOLDOWN_S``;
* **hysteresis**: any action resets both streaks, and the down cooldown
  counts from the last action of either direction;
* **chaos replacement**: a replica that died without being removed is
  respawned on the next tick, outside the cooldowns (repair is not
  scaling); a replica on the card starts from the kernels already built
  in ``build/heat_tpu_torch/``.

The decision table is the JAX package's, row for row: ``clock``,
``metrics_fn`` and the three actuators (``scale_up_fn``,
``scale_down_fn``, ``replace_fn``) are injectable, so :meth:`tick` is a
pure step over a scripted trace whose verdicts land in ``history``.

Telemetry: each action emits one ``autoscale`` event with its
``autoscale.<counter>`` increment (``EVENT_COUNTER``, which
``telemetry.report`` replays); ``replica_seconds`` integrates the live
footprint over time.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional

from ... import _knobs as knobs
from ... import telemetry

__all__ = ["AutoscaleController", "EVENT_COUNTER"]

# autoscale event -> counter suffix (the serve_net events' contract)
EVENT_COUNTER = {
    "scale_up": "scale_ups",       # one replica spawned and joined
    "scale_down": "scale_downs",   # one replica drained and removed
    "replace": "replacements",     # a dead replica respawned
}


def _emit(event: str, **fields: Any) -> None:
    """One ``autoscale`` event and its counter (one flag check while
    telemetry is off)."""
    if not telemetry.enabled():
        return
    reg = telemetry.get_registry()
    reg.add(f"autoscale.{EVENT_COUNTER[event]}", 1)
    reg.emit("autoscale", "controller", event=event, **fields)


def _knob(value, name, cast):
    return cast(knobs.get(name) if value is None else value)


class AutoscaleController:
    """SLO-holding replica-count controller over a
    :class:`~.pool.ReplicaPool` + :class:`~.router.Router` pair (module
    docstring has the policy). Construct with ``pool``/``router`` for
    live control, or with ``metrics_fn`` + actuator stubs for
    deterministic decision-table tests."""

    def __init__(
        self,
        pool=None,
        router=None,
        *,
        min_replicas: Optional[int] = None,
        max_replicas: Optional[int] = None,
        backlog_high: Optional[float] = None,
        backlog_ticks: Optional[int] = None,
        idle_low: Optional[float] = None,
        idle_ticks: Optional[int] = None,
        up_cooldown_s: Optional[float] = None,
        down_cooldown_s: Optional[float] = None,
        tick_interval_s: Optional[float] = None,
        slo_check_every: int = 1,
        clock: Callable[[], float] = time.monotonic,
        metrics_fn: Optional[Callable[[], dict]] = None,
        scale_up_fn: Optional[Callable[[], Any]] = None,
        scale_down_fn: Optional[Callable[[], Any]] = None,
        replace_fn: Optional[Callable[[Any], Any]] = None,
    ):
        self.pool = pool
        self.router = router
        self.min_replicas = _knob(min_replicas, "HEAT_TPU_AUTOSCALE_MIN", int)
        self.max_replicas = _knob(max_replicas, "HEAT_TPU_AUTOSCALE_MAX", int)
        if self.min_replicas < 1 or self.max_replicas < self.min_replicas:
            raise ValueError(
                f"need 1 <= min <= max, got min={self.min_replicas} "
                f"max={self.max_replicas}"
            )
        self.backlog_high = _knob(
            backlog_high, "HEAT_TPU_AUTOSCALE_BACKLOG_HIGH", float
        )
        self.backlog_ticks = max(1, _knob(
            backlog_ticks, "HEAT_TPU_AUTOSCALE_BACKLOG_TICKS", int
        ))
        self.idle_low = _knob(idle_low, "HEAT_TPU_AUTOSCALE_IDLE_LOW", float)
        self.idle_ticks_needed = max(1, _knob(
            idle_ticks, "HEAT_TPU_AUTOSCALE_IDLE_TICKS", int
        ))
        self.up_cooldown_s = _knob(
            up_cooldown_s, "HEAT_TPU_AUTOSCALE_UP_COOLDOWN_S", float
        )
        self.down_cooldown_s = _knob(
            down_cooldown_s, "HEAT_TPU_AUTOSCALE_DOWN_COOLDOWN_S", float
        )
        self.tick_interval_s = _knob(
            tick_interval_s, "HEAT_TPU_AUTOSCALE_TICK_S", float
        )
        # SLO-burn probing scrapes every replica's /metrics — at small
        # tick intervals that wall-clock cost would crowd out the tick
        # cadence itself, so the check may run every Nth tick (the burn
        # verdict holds between probes; backlog/shed stay per-tick)
        self.slo_check_every = max(1, int(slo_check_every))
        self._last_burn = False
        self.clock = clock
        self.metrics_fn = metrics_fn
        self._scale_up_fn = scale_up_fn or self._default_scale_up
        self._scale_down_fn = scale_down_fn or self._default_scale_down
        self._replace_fn = replace_fn or self._default_replace
        # decision state
        self.ticks = 0
        self._hot_ticks = 0
        self._idle_ticks = 0
        self._last_shed: Optional[int] = None
        self._last_up = float("-inf")      # up allowed on the first tick
        self._last_action = float("-inf")
        self.history: List[dict] = []
        self.counts = {"scale_ups": 0, "scale_downs": 0, "replacements": 0,
                       "clamped_max": 0, "clamped_min": 0}
        # replica-seconds integral (the footprint over time)
        self.replica_seconds = 0.0
        self._last_tick_t: Optional[float] = None
        # background loop
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- observation ---------------------------------------------------------

    def _observe(self) -> dict:
        """One sensor reading. Scripted mode (``metrics_fn``) returns it
        verbatim; live mode derives it from the router's routing state +
        SLO accounting and the pool's process liveness:

        * ``replicas`` — live serving processes;
        * ``backlog`` — admitted-but-unresolved work (per-replica polled
          pending + router in-flight + router queue depth);
        * ``slo_burn`` — any declared SLO burning above threshold
          (``Router.check_slos()`` emits the breach events as a side
          effect — the controller IS that signal's consumer);
        * ``shed`` — cumulative router sheds (the tick diffs it);
        * ``dead`` — pool indices that died without being removed.
        """
        if self.metrics_fn is not None:
            return dict(self.metrics_fn())
        rs = self.router.stats()
        backlog = sum(
            r["score"] for r in rs["replicas"].values() if r["up"]
        ) + rs["queue_depth"]
        burn = self._last_burn
        if self.router.slos and self.ticks % self.slo_check_every == 0:
            try:
                burn = any(
                    row.get("breach") for row in self.router.check_slos()
                )
            except Exception:  # noqa: BLE001 — scrape trouble is not a
                burn = False   # scale signal; the ops plane flags suspects
            self._last_burn = burn
        dead: List[int] = []
        replicas = 0
        if self.pool is not None:
            for h in self.pool.replicas:
                if h.state == "up":
                    if h.alive():
                        replicas += 1
                    else:
                        dead.append(h.index)
        else:
            replicas = sum(1 for r in rs["replicas"].values() if r["up"])
        return {
            "replicas": replicas,
            "backlog": backlog,
            "slo_burn": burn,
            "shed": rs["router"]["shed"],
            "dead": dead,
        }

    # -- default actuators (live pool + router binding) ----------------------

    def _default_scale_up(self):
        h = self.pool.spawn()
        if self.router is not None:
            self.router.add_target(h.url)
        return h.index

    def _default_scale_down(self):
        # newest live replica drains first (LIFO keeps the long-lived
        # base footprint — and its warm caches — stable)
        live = [h for h in self.pool.replicas
                if h.state == "up" and h.alive()]
        if not live:
            return None
        h = live[-1]
        if self.router is not None and h.url:
            self.router.remove_target(h.url)
        self.pool.remove(h.index)
        return h.index

    def _default_replace(self, index):
        old = self.pool.handle(index)
        old.state = "dead"
        if self.router is not None and old.url:
            self.router.remove_target(old.url)
        h = self.pool.spawn()
        if self.router is not None:
            self.router.add_target(h.url)
        return h.index

    # -- the decision step ---------------------------------------------------

    def tick(self) -> dict:
        """One observe → decide → act step; returns (and records in
        ``self.history``) the decision row. Deterministic given the
        injected clock + metrics: no sleeps, no wall-clock reads."""
        now = self.clock()
        obs = self._observe()
        self.ticks += 1
        if self._last_tick_t is not None:
            self.replica_seconds += (
                max(0.0, now - self._last_tick_t) * obs["replicas"]
            )
        self._last_tick_t = now
        row: Dict[str, Any] = {
            "tick": self.ticks, "t": now, "obs": obs, "action": "hold",
        }

        # 1. repair before policy: a dead replica is replaced 1:1,
        # outside the cooldown discipline
        for index in list(obs.get("dead") or ()):
            try:
                new = self._replace_fn(index)
            except Exception as e:  # noqa: BLE001 — a failed respawn is
                row["replace_error"] = repr(e)  # data, not a crashed loop
                continue
            self.counts["replacements"] += 1
            row.setdefault("replaced", []).append(
                {"old": index, "new": new}
            )
            _emit("replace", old=index, new=new, tick=self.ticks)
        if "replaced" in row:
            row["action"] = "replace"
            self._last_action = now
            self._hot_ticks = 0
            self._idle_ticks = 0

        # 2. streaks (hysteresis state)
        n = max(1, int(obs["replicas"]))
        per_replica = obs["backlog"] / n
        shed = int(obs.get("shed") or 0)
        shed_delta = 0 if self._last_shed is None else shed - self._last_shed
        self._last_shed = shed
        row["per_replica_backlog"] = round(per_replica, 3)
        row["shed_delta"] = shed_delta
        pressure = (
            bool(obs.get("slo_burn"))
            or per_replica >= self.backlog_high
            or shed_delta > 0
        )
        if pressure:
            self._hot_ticks += 1
            self._idle_ticks = 0
        elif per_replica <= self.idle_low and shed_delta == 0:
            self._idle_ticks += 1
            self._hot_ticks = 0
        else:
            self._hot_ticks = 0
            self._idle_ticks = 0
        row["hot_ticks"] = self._hot_ticks
        row["idle_ticks"] = self._idle_ticks

        # 3. decide + clamp + cooldown
        want = 0
        if bool(obs.get("slo_burn")) or self._hot_ticks >= self.backlog_ticks:
            want = 1
        elif self._idle_ticks >= self.idle_ticks_needed:
            want = -1
        if want > 0:
            if int(obs["replicas"]) >= self.max_replicas:
                row["action"] = "clamp_max"
                self.counts["clamped_max"] += 1
            elif now - self._last_up < self.up_cooldown_s:
                row["action"] = "cooldown_up"
            else:
                try:
                    new = self._scale_up_fn()
                except Exception as e:  # noqa: BLE001
                    row["action"] = "scale_up_error"
                    row["error"] = repr(e)
                else:
                    row["action"] = "scale_up"
                    row["replica"] = new
                    self.counts["scale_ups"] += 1
                    self._last_up = now
                    self._last_action = now
                    self._hot_ticks = 0
                    self._idle_ticks = 0
                    _emit(
                        "scale_up", replica=new, tick=self.ticks,
                        reason="slo_burn" if obs.get("slo_burn")
                        else ("shed" if shed_delta > 0 else "backlog"),
                        per_replica_backlog=round(per_replica, 3),
                    )
        elif want < 0:
            if int(obs["replicas"]) <= self.min_replicas:
                row["action"] = "clamp_min"
                self.counts["clamped_min"] += 1
                self._idle_ticks = 0
            elif now - self._last_action < self.down_cooldown_s:
                row["action"] = "cooldown_down"
            else:
                try:
                    gone = self._scale_down_fn()
                except Exception as e:  # noqa: BLE001
                    row["action"] = "scale_down_error"
                    row["error"] = repr(e)
                else:
                    row["action"] = "scale_down"
                    row["replica"] = gone
                    self.counts["scale_downs"] += 1
                    self._last_action = now
                    self._idle_ticks = 0
                    self._hot_ticks = 0
                    _emit("scale_down", replica=gone, tick=self.ticks)
        self.history.append(row)
        return row

    # -- background loop -----------------------------------------------------

    def start(self) -> "AutoscaleController":
        """Run ``tick()`` every ``tick_interval_s`` seconds on a daemon
        thread until :meth:`stop`."""
        if self._thread is not None:
            return self
        self._stop.clear()

        def _loop():
            while not self._stop.is_set():
                try:
                    self.tick()
                except Exception:  # noqa: BLE001 — the loop must survive
                    pass           # one bad scrape; the row records errors
                self._stop.wait(self.tick_interval_s)

        self._thread = threading.Thread(
            target=_loop, name="heat_tpu_torch.serve.net.autoscale", daemon=True,
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        """Stop the background loop (idempotent; the pool/router stay
        up — the controller only ever owns the POLICY)."""
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(5.0)

    def stats(self) -> dict:
        """Decision-plane counters + footprint integral (the
        CI-gate surface)."""
        return {
            "ticks": self.ticks,
            "replica_seconds": round(self.replica_seconds, 3),
            "hot_ticks": self._hot_ticks,
            "idle_ticks": self._idle_ticks,
            **self.counts,
        }

    def __enter__(self) -> "AutoscaleController":
        return self

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False
