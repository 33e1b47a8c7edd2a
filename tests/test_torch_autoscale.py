"""``heat_tpu_torch.serve.net``'s autoscaler, priority classes and hedged
retries against ``heat_tpu.serve.net`` on the CPU.

- ``AutoscaleController``: the JAX tests' scripted traces
  (``tests/test_autoscale.py``) through both controllers, with a counter
  clock and recording actuators, give the same ``history`` rows (action,
  replica, streaks, per-replica backlog, shed delta, replacements) and the
  same counts and replica-seconds; bounds are validated alike; the live
  binding drives a fake pool and the router's ``add_target``/
  ``remove_target``; the ``autoscale`` events replay to the live counters.
- ``_FairQueue``: seeded sequences of puts, gets and sheds through both
  queues come out in the same order and shed the same jobs.
- ``_parse_weights`` accepts and rejects the same strings.
- The router against scripted fake replicas (``tests/test_torch_serve_net``):
  a bulk flood past the queue bound sheds only bulk work; a hedge against a
  slow replica wins and the loser is cancelled; the hedge budget blocks a
  cold router; the fixed and the p95-derived hedge delays.
- The registered autoscale, priority and hedge knobs are the JAX package's.
"""

import itertools
import time
from types import SimpleNamespace

import numpy as np
import pytest

from heat_tpu import _knobs as jax_knobs
from heat_tpu.serve.net import AutoscaleController as JaxController
from heat_tpu.serve.net.router import _FairQueue as JaxFairQueue
from heat_tpu.serve.net.router import _parse_weights as jax_parse_weights

from heat_tpu_torch import _knobs, telemetry
from heat_tpu_torch.serve import ServerOverloadedError
from heat_tpu_torch.serve.net import AutoscaleController, Router
from heat_tpu_torch.serve.net.router import _FairQueue, _parse_weights

from tests.test_torch_serve_net import _FakeReplica, _ok_body, _wait_until


def _obs(replicas=1, backlog=0.0, burn=False, shed=0, dead=()):
    return {"replicas": replicas, "backlog": backlog, "slo_burn": burn,
            "shed": shed, "dead": list(dead)}


# (script, overrides, ticks): the scripted traces of tests/test_autoscale.py
_TRACES = {
    "slo_burn": ([_obs(burn=True)], {}, 1),
    "backlog_streak": ([_obs(backlog=10.0)] * 2, {}, 2),
    "streak_reset": ([_obs(backlog=10.0), _obs(backlog=1.0), _obs(backlog=10.0),
                      _obs(backlog=10.0)], {}, 4),
    "shed_delta": ([_obs(shed=0), _obs(shed=3), _obs(shed=6)], {}, 3),
    "up_cooldown": ([_obs(replicas=1 + min(i, 1), burn=True) for i in range(4)],
                    {"up_cooldown_s": 3.0}, 4),
    "drain_idle": ([_obs(replicas=2)] * 2, {}, 2),
    "hysteresis": ([_obs(backlog=10.0), _obs(backlog=10.0)] + [_obs(replicas=2)] * 4,
                   {"down_cooldown_s": 3.0, "idle_ticks": 1}, 6),
    "clamp_max": ([_obs(replicas=2, burn=True)] * 2, {"max_replicas": 2}, 2),
    "clamp_min": ([_obs()] * 4, {"idle_ticks": 2}, 4),
    "replace_in_cooldown": ([_obs(burn=True), _obs(replicas=2, backlog=2.0, dead=[0])],
                            {"up_cooldown_s": 100.0}, 2),
    "replica_seconds": ([_obs(replicas=2, backlog=1.0)] * 3, {}, 3),
    "diurnal": ([_obs(backlog=b, shed=s) for b, s in
                 [(0, 0), (6, 0), (9, 1), (9, 4), (3, 4), (0, 4), (0, 4), (0, 4), (0, 4),
                  (0, 4), (12, 4), (12, 9), (0, 9)]],
                {"idle_ticks": 3, "down_cooldown_s": 2.0, "up_cooldown_s": 1.0}, 13),
}


class _Scripted:
    """A controller of either package over a scripted trace, a counter
    clock (one second a tick) and recording actuators."""

    def __init__(self, cls, script, **over):
        self.script = iter(script)
        self.ups, self.downs, self.replaced = 0, 0, []
        counter = itertools.count()
        kw = dict(min_replicas=1, max_replicas=4, backlog_high=4.0, backlog_ticks=2,
                  idle_low=0.5, idle_ticks=2, up_cooldown_s=0.0, down_cooldown_s=0.0,
                  tick_interval_s=0.01, clock=lambda: float(next(counter)),
                  metrics_fn=lambda: next(self.script), scale_up_fn=self._up,
                  scale_down_fn=self._down, replace_fn=self._replace)
        kw.update(over)
        self.ctrl = cls(**kw)

    def _up(self):
        self.ups += 1
        return 100 + self.ups

    def _down(self):
        self.downs += 1
        return 200 + self.downs

    def _replace(self, index):
        self.replaced.append(index)
        return 300 + len(self.replaced)

    def run(self, n):
        for _ in range(n):
            self.ctrl.tick()
        return self


@pytest.mark.parametrize("trace", sorted(_TRACES))
def test_scripted_traces_give_the_jax_controllers_history(trace):
    script, over, ticks = _TRACES[trace]
    mine = _Scripted(AutoscaleController, script, **over).run(ticks)
    theirs = _Scripted(JaxController, script, **over).run(ticks)
    assert mine.ctrl.history == theirs.ctrl.history
    assert mine.ctrl.counts == theirs.ctrl.counts
    assert mine.ctrl.stats() == theirs.ctrl.stats()
    assert (mine.ups, mine.downs, mine.replaced) == (theirs.ups, theirs.downs, theirs.replaced)


def test_the_verdicts_of_the_jax_tests():
    """The verdicts the JAX tests assert, on the port alone."""
    acts = lambda t: [r["action"] for r in _Scripted(  # noqa: E731
        AutoscaleController, _TRACES[t][0], **_TRACES[t][1]).run(_TRACES[t][2]).ctrl.history]
    assert acts("slo_burn") == ["scale_up"]
    assert acts("streak_reset") == ["hold", "hold", "hold", "scale_up"]
    assert acts("up_cooldown") == ["scale_up", "cooldown_up", "cooldown_up", "scale_up"]
    assert acts("hysteresis") == ["hold", "scale_up", "cooldown_down", "cooldown_down",
                                  "scale_down", "cooldown_down"]
    assert acts("replace_in_cooldown") == ["scale_up", "replace"]
    s = _Scripted(AutoscaleController, _TRACES["replica_seconds"][0]).run(3)
    assert s.ctrl.replica_seconds == pytest.approx(4.0)


def test_actuator_errors_and_bounds_as_in_the_jax_package():
    def boom():
        raise RuntimeError("no capacity")

    for cls in (AutoscaleController, JaxController):
        s = _Scripted(cls, [_obs(burn=True)], scale_up_fn=boom).run(1)
        assert s.ctrl.history[0]["action"] == "scale_up_error"
        assert "no capacity" in s.ctrl.history[0]["error"]
        for lo, hi in ((0, 2), (3, 2)):
            with pytest.raises(ValueError):
                cls(min_replicas=lo, max_replicas=hi, metrics_fn=lambda: _obs())


class _FakeHandle:
    def __init__(self, index, url):
        self.index, self.url, self.state = index, url, "up"
        self.dead = False

    def alive(self):
        return not self.dead


class _FakePool:
    """The pool's surface the live binding uses: ``replicas``, ``spawn``,
    ``remove``, ``handle``; each spawned replica is a fake front."""

    def __init__(self, n):
        self.fakes, self.replicas = [], []
        for _ in range(n):
            self.spawn()

    def spawn(self):
        fake = _FakeReplica(_ok_body)
        self.fakes.append(fake)
        h = _FakeHandle(len(self.replicas), fake.url)
        self.replicas.append(h)
        return h

    def handle(self, index):
        return self.replicas[index]

    def remove(self, index):
        self.replicas[index].state = "removed"
        return 0

    def urls(self):
        return [h.url for h in self.replicas if h.state == "up"]

    def stop(self):
        for f in self.fakes:
            f.stop()


def test_live_binding_drives_the_pool_and_the_router():
    """Burn scales up (the new replica joins the router), a dead replica is
    replaced (the dead target detached), idle ticks drain the newest
    replica out of the router and the pool."""
    pool = _FakePool(1)
    router = Router(pool, workers=1, poll_ms=1000.0)
    clock = itertools.count()
    ctrl = AutoscaleController(pool, router, min_replicas=1, max_replicas=3, idle_ticks=1,
                               up_cooldown_s=0.0, down_cooldown_s=0.0,
                               clock=lambda: float(next(clock)))
    try:
        ctrl._last_burn = True  # no SLOs declared: the burn verdict stays as set
        assert ctrl.tick()["action"] == "scale_up"
        assert len(router.stats()["replicas"]) == 2
        ctrl._last_burn = False
        pool.replicas[0].dead = True
        row = ctrl.tick()
        # repaired first; the same tick then sees one live idle replica
        assert row["replaced"] == [{"old": 0, "new": 2}] and row["action"] == "clamp_min"
        assert pool.replicas[0].url not in router.stats()["replicas"]
        assert ctrl.tick()["action"] == "scale_down"
        assert pool.replicas[2].state == "removed"
        assert list(router.stats()["replicas"]) == [pool.replicas[1].url]
        assert ctrl.counts["scale_ups"] == 1 and ctrl.counts["replacements"] == 1
    finally:
        router.close()
        pool.stop()


def test_autoscale_events_replay_to_the_live_counters():
    reg = telemetry.get_registry()
    was = telemetry.enabled()
    telemetry.enable()
    reg.clear()
    try:
        s = _Scripted(AutoscaleController, [
            _obs(burn=True), _obs(replicas=2, backlog=2.0, dead=[0]),
            _obs(replicas=2), _obs(replicas=2)]).run(4)
        assert [r["action"] for r in s.ctrl.history] == ["scale_up", "replace", "hold",
                                                          "scale_down"]
        live = telemetry.report.summarize()
        assert live["autoscale"] == {"scale_ups": 1, "replacements": 1, "scale_downs": 1}
        offline = telemetry.report.summarize(list(reg.events), dict(reg.watermarks))
        assert offline["autoscale"] == live["autoscale"]
    finally:
        reg.clear()
        if not was:
            telemetry.disable()


# -- the weighted-fair queue -------------------------------------------------------


def _drive(queue_cls, weights, ops):
    """Run one op sequence through a queue; the trace of what came out."""
    q = queue_cls(weights)
    out = []
    for kind, arg in ops:
        if kind == "put":
            q.put(SimpleNamespace(cls=arg[0], tag=arg[1]))
        elif kind == "get":
            try:
                j = q.get_nowait()
                out.append(("got", None if j is None else j.tag))
            except Exception as e:  # both raise queue.Empty
                out.append(("empty", type(e).__name__))
        elif kind == "shed":
            j = q.shed_lowest(arg)
            out.append(("shed", None if j is None else j.tag))
        elif kind == "top":
            out.append(("top", q.max_queued_weight()))
        else:
            q.put(None)
        out.append(("size", q.qsize()))
    return out


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("weights", [{}, {"a": 3.0, "b": 1.0},
                                     {"latency": 8.0, "bulk": 1.0, "batch": 0.5}])
def test_fair_queues_agree_on_order_and_sheds(seed, weights):
    rng = np.random.default_rng(seed)
    classes = sorted(weights) or ["default"]
    ops, n = [], 0
    for _ in range(300):
        r = rng.random()
        if r < 0.5:
            ops.append(("put", (classes[int(rng.integers(len(classes)))], f"j{n}")))
            n += 1
        elif r < 0.85:
            ops.append(("get", None))
        elif r < 0.95:
            ops.append(("shed", float(rng.choice([0.5, 1.0, 3.0, 8.0, 100.0]))))
        elif r < 0.98:
            ops.append(("top", None))
        else:
            ops.append(("control", None))
    mine = _drive(_FairQueue, weights, ops)
    assert mine == _drive(JaxFairQueue, weights, ops)
    assert any(k == "got" for k, _ in mine)


def test_fair_queue_proportions_and_fifo():
    q = _FairQueue({"a": 3.0, "b": 1.0})
    for i in range(40):
        q.put(SimpleNamespace(cls="a", tag=f"a{i}"))
        q.put(SimpleNamespace(cls="b", tag=f"b{i}"))
    first = [q.get_nowait().cls for _ in range(40)]
    assert first.count("a") == 30 and first.count("b") == 10
    q = _FairQueue({})
    for i in range(10):
        q.put(SimpleNamespace(cls="default", tag=i))
    assert [q.get_nowait().tag for _ in range(10)] == list(range(10))


@pytest.mark.parametrize("spec", ["latency=8,bulk=1", " latency = 8 ; bulk = 1 ", "", None,
                                  "a=0.5", "x=1,x=2", "latency", "latency=0", "bulk=-1",
                                  "a=b", "a=1,,b=2"])
def test_parse_weights_accepts_and_rejects_as_the_jax_package(spec):
    try:
        want = jax_parse_weights(spec)
    except ValueError:
        with pytest.raises(ValueError):
            _parse_weights(spec)
        return
    assert _parse_weights(spec) == want


# -- the router against fake replicas -------------------------------------------------


def test_bulk_flood_never_sheds_the_latency_class():
    fake = _FakeReplica(lambda: (time.sleep(0.02), _ok_body())[1])
    router = Router([fake.url], workers=1, poll_ms=1000.0,
                    priorities={"latency": 8.0, "bulk": 1.0},
                    endpoint_priorities={"kmeans": "latency", "cdist": "bulk"},
                    priority_queue_max=6)
    try:
        x = np.zeros((1, 2), np.float32)
        bulk = [router.submit("cdist", x) for _ in range(30)]
        _wait_until(lambda: fake.posts >= 2, what="bulk dispatch")
        lat = [router.submit("kmeans", x) for _ in range(6)]
        for f in lat:
            f.result(30.0)  # raises if a latency job was shed
        shed = ok = 0
        for f in bulk:
            try:
                f.result(30.0)
                ok += 1
            except ServerOverloadedError as e:
                assert e.reason == "priority_shed"
                shed += 1
        st = router.stats()
        assert st["priority"]["classes"]["latency"].get("shed", 0) == 0
        assert shed >= 1 and ok >= 1
        assert st["router"]["priority_sheds"] == shed
    finally:
        router.close()
        fake.stop()


def test_hedge_first_wins_and_the_loser_is_cancelled():
    slow = _FakeReplica(lambda: (time.sleep(0.6), _ok_body())[1])
    fast = _FakeReplica(_ok_body)
    router = Router([slow.url, fast.url], workers=1, poll_ms=1000.0, hedge=True,
                    hedge_delay_ms=50.0, hedge_max_fraction=1.0)
    try:
        t0 = time.perf_counter()
        got = router.predict("e", np.zeros((1, 2), np.float32))
        assert time.perf_counter() - t0 < 0.55
        assert np.asarray(got).tobytes() == np.arange(6, dtype=np.float32).tobytes()
        counts = router.stats()["router"]
        assert counts["hedges"] == 1 and counts["hedge_wins"] == 1
        assert slow.posts == 1 and fast.posts == 1
    finally:
        router.close()
        slow.stop()
        fast.stop()


def test_hedge_budget_blocks_a_cold_router():
    slow = _FakeReplica(lambda: (time.sleep(0.25), _ok_body())[1])
    fast = _FakeReplica(_ok_body)
    router = Router([slow.url, fast.url], workers=1, poll_ms=1000.0, hedge=True,
                    hedge_delay_ms=30.0, hedge_max_fraction=0.01)
    try:
        router.predict("e", np.zeros((1, 2), np.float32))
        assert router.stats()["router"]["hedges"] == 0
    finally:
        router.close()
        slow.stop()
        fast.stop()


def test_hedge_delay_fixed_and_p95_derived():
    fake = _FakeReplica(_ok_body)
    router = Router([fake.url], workers=1, poll_ms=1000.0, hedge=True, hedge_delay_ms=75.0)
    try:
        assert router._hedge_delay_s("e") == pytest.approx(0.075)
        router.hedge_delay_ms = 0.0
        router.hedge_min_samples = 5
        assert router._hedge_delay_s("e") is None
        for _ in range(5):
            router.predict("e", np.zeros((1, 2), np.float32))
        d = router._hedge_delay_s("e")
        assert d is not None and d > 0.0
    finally:
        router.close()
        fake.stop()


def test_the_knobs_of_this_tier_are_the_jax_packages():
    names = [n for n in jax_knobs.REGISTRY
             if n.startswith(("HEAT_TPU_AUTOSCALE_", "HEAT_TPU_HEDGE_",
                              "HEAT_TPU_SERVE_PRIORITY_"))]
    assert len(names) == 16
    for n in names:
        mine, theirs = _knobs.REGISTRY[n], jax_knobs.REGISTRY[n]
        assert (mine.type, mine.default, mine.tunable) == (theirs.type, theirs.default,
                                                           theirs.tunable)
        assert _knobs.get(n) == jax_knobs.get(n)
