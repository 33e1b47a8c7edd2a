"""Least-loaded request router over a set of replica HTTP fronts.

Counterpart of ``heat_tpu/serve/net/router.py``: N replica processes
(each a :class:`~heat_tpu_torch.serve.Server` behind
:class:`~.transport.HttpFront`) look like one server to a client.

* **least-loaded dispatch**: a poll thread refreshes every healthy
  replica's ``/stats`` each ``HEAT_TPU_SERVE_NET_POLL_MS``; a request goes
  to the replica of least polled backlog plus this router's own
  in-flight count to it. ``max_inflight`` caps the concurrent requests a
  replica (a worker waits for a slot; past the deadline it sheds
  ``router_timeout``).
* **sticky degradation**: a 503 shed from one replica retries up to
  ``HEAT_TPU_SERVE_NET_RETRIES`` siblings before the client sees
  :class:`ServerOverloadedError`; a replica that sheds for load is not
  evicted, one that answers ``draining`` or ``closed`` is (it is leaving).
* **health eviction and re-add**: a refused connection evicts the
  replica; the poll thread probes ``/healthz`` and re-adds it when it
  answers.
* **failure semantics**: a refused connection never saw the request (a
  sibling may serve it); a connection that drops after the send fails
  with :class:`ReplicaDownError` unless ``retry_in_flight=True``; a
  response that does not come within the timeout fails without eviction.
  A kept-alive connection that the replica closed while it was idle (a
  drained replica exits) is replaced before a request is sent on it, and
  a draining replica closes each connection after its answer, so a
  rolling update loses no request.

* **priority classes**: a request carries a class (per endpoint through
  ``endpoint_priorities``/:meth:`Router.set_priority`, per request through
  ``submit(priority=...)``); the workers drain the queue by smooth weighted
  round-robin over the class weights (``HEAT_TPU_SERVE_PRIORITY_WEIGHTS``),
  so a bulk tenant cannot starve a latency tenant. With
  ``HEAT_TPU_SERVE_PRIORITY_QUEUE_MAX`` bounding the queue, the newest job
  of the lowest-weight queued class sheds first (``priority_shed``), and a
  503-shed request yields its sibling retries while higher-priority work
  waits. No classes configured: first in, first out.
* **hedged retries**: with ``HEAT_TPU_HEDGE_ENABLE``, a first attempt that
  has not answered within the hedge delay (``HEAT_TPU_HEDGE_DELAY_MS``, or
  the endpoint's observed p95 once ``HEAT_TPU_HEDGE_MIN_SAMPLES``
  completions exist) is duplicated to an idle sibling; the first HTTP
  answer wins and the loser is cancelled by closing its connection.
  ``HEAT_TPU_HEDGE_MAX_FRACTION`` caps hedges against completed requests.
  Endpoints are pure (restored estimators), so a duplicate run is harmless.

The autoscaler that drives :meth:`Router.add_target`/
:meth:`Router.remove_target` is :class:`~.controller.AutoscaleController`.

The client surface is the in-process server's: ``submit()`` returns a
future, ``predict()`` blocks, ``stats()["endpoints"]`` carries the same
per-endpoint aggregates. The fleet views are the JAX package's, over
:mod:`heat_tpu_torch.telemetry.cluster`: ``cluster_summary`` (fleet QPS,
exactly merged latency quantiles, per-replica rows, the SLO burn rates of
the declared ``slos``), ``check_slos`` (an ``slo_burn`` event a breach),
``prometheus_text`` and ``export_cluster_trace`` (one Perfetto trace of the
router and every replica, clock offsets corrected).
"""

from __future__ import annotations

import http.client
import json
import queue as _queue_mod
import select
import threading
import time
from collections import deque
from concurrent.futures import Future
from queue import Empty
from typing import Dict, List, Optional, Sequence, Tuple, Union
from urllib.parse import urlparse

import numpy as np

from ... import _knobs as knobs
from .. import tracing
from ..admission import ServeError, ServerClosedError, ServerOverloadedError
from ..metrics import EndpointStats
from . import wire
from .events import emit as _emit

__all__ = ["Router", "ReplicaDownError"]

_POLL_TIMEOUT = 2.0  # seconds per /stats / /healthz probe


class _NoDelayConnection(http.client.HTTPConnection):
    """HTTPConnection with Nagle disabled — request/response pairs are
    single small write-read exchanges, exactly the pattern Nagle +
    delayed ACK stalls (measured: 33 ms loopback round trips without
    this, ~3 ms with)."""

    def connect(self):
        super().connect()
        import socket as _socket

        self.sock.setsockopt(
            _socket.IPPROTO_TCP, _socket.TCP_NODELAY, 1
        )


class ReplicaDownError(ServeError):
    """No healthy replica could (safely) serve the request: every
    candidate was down, or the chosen replica's connection dropped with
    the request in flight (``retry_in_flight=False``)."""


class _Target:
    """One replica as the router sees it."""

    __slots__ = ("url", "host", "port", "up", "inflight", "polled_pending",
                 "poll_fails", "evictions", "suspect")

    def __init__(self, url: str):
        parsed = urlparse(url if "//" in url else f"http://{url}")
        if not parsed.hostname or not parsed.port:
            raise ValueError(f"replica url needs host:port, got {url!r}")
        self.url = f"http://{parsed.hostname}:{parsed.port}"
        self.host = parsed.hostname
        self.port = parsed.port
        self.up = True
        self.inflight = 0
        self.polled_pending = 0
        self.poll_fails = 0
        self.evictions = 0
        self.suspect = False  # ops scrape failed after retry

    def score(self) -> int:
        # routing state is guarded by the router's one Condition; reads
        # of two ints race only with themselves (shed tolerance: the
        # score is a heuristic, not an allocator)
        return self.polled_pending + self.inflight


class _Job:
    __slots__ = ("endpoint", "body", "future", "t0", "t_wall", "ctx",
                 "cls", "weight")

    def __init__(self, endpoint: str, body: bytes, ctx=None,
                 cls: str = "default", weight: float = 1.0):
        self.endpoint = endpoint
        self.body = body
        self.future: Future = Future()
        self.t0 = time.perf_counter()
        # wall twin of t0, trace-only (spans anchor on wall clock)
        self.t_wall = time.time() if ctx is not None else 0.0
        self.ctx = ctx  # Optional[tracing.TraceContext]
        self.cls = cls          # priority class
        self.weight = weight    # the class's configured weight


class _FairQueue:
    """Weighted-fair multi-class FIFO: jobs queue per
    priority class; :meth:`get` drains classes by smooth weighted
    round-robin over the configured weights, so over any window each
    backlogged class is served in proportion to its weight — a
    high-rate bulk class cannot starve a latency class, and the bulk
    class still receives its weight share. With a single class (no
    priorities configured) this degenerates to exactly the old FIFO.
    Worker-shutdown sentinels (``None``) ride a control lane served
    before any job."""

    def __init__(self, weights: Dict[str, float]):
        self._cv = threading.Condition()
        self._weights = {k: float(v) for k, v in weights.items()}
        self._classes: Dict[str, deque] = {}
        self._credit: Dict[str, float] = {}
        self._control: deque = deque()
        self._size = 0

    def weight(self, cls: str) -> float:
        return self._weights.get(cls, 1.0)

    def put(self, job) -> None:
        with self._cv:
            if job is None:
                self._control.append(None)
            else:
                self._classes.setdefault(job.cls, deque()).append(job)
                self._size += 1
            self._cv.notify()

    def qsize(self) -> int:
        return self._size  # racy read, same tolerance as Queue.qsize

    def _pick_locked(self):
        live = [c for c, q in self._classes.items() if q]
        if not live:
            return None
        if len(live) == 1:
            chosen = live[0]
        else:
            # smooth weighted round-robin: every nonempty class earns
            # its weight in credit, the richest class is served and
            # pays the round's total — proportions converge to the
            # weights with bounded per-class latency
            total = 0.0
            chosen = None
            best = None
            for c in sorted(live):  # sorted: deterministic tie-break
                w = self.weight(c)
                self._credit[c] = self._credit.get(c, 0.0) + w
                total += w
                if best is None or self._credit[c] > best:
                    best = self._credit[c]
                    chosen = c
            self._credit[chosen] -= total
        job = self._classes[chosen].popleft()
        self._size -= 1
        return job

    def get(self):
        with self._cv:
            while True:
                if self._control:
                    return self._control.popleft()
                job = self._pick_locked()
                if job is not None:
                    return job
                self._cv.wait()

    def get_nowait(self):
        with self._cv:
            if self._control:
                return self._control.popleft()
            job = self._pick_locked()
            if job is None:
                raise Empty
            return job

    def shed_lowest(self, below_weight: float):
        """Pop (to shed) the NEWEST job of the lowest-weight nonempty
        class with weight strictly below ``below_weight`` — the
        priority-aware shed order. ``None`` when every queued job is at
        or above that priority."""
        with self._cv:
            best_c = None
            best_w = None
            for c, q in self._classes.items():
                if not q:
                    continue
                w = self.weight(c)
                if w >= below_weight:
                    continue
                if best_w is None or w < best_w:
                    best_w, best_c = w, c
            if best_c is None:
                return None
            job = self._classes[best_c].pop()  # newest arrival sheds first
            self._size -= 1
            return job

    def max_queued_weight(self) -> Optional[float]:
        """Highest weight among classes with queued work (the
        priority-yield probe)."""
        with self._cv:
            ws = [self.weight(c) for c, q in self._classes.items() if q]
        return max(ws) if ws else None


class _InFlightDrop(Exception):
    """Connection died after the request was on the wire (internal)."""


class _ResponseTimeout(Exception):
    """The replica accepted the request but did not answer within the
    socket timeout (internal). NOT an outage: the replica is healthy,
    just slow — it must not be evicted, and the request must not be
    blindly retried (it may still execute)."""


class Router:
    """Least-loaded HTTP router over replica fronts (module docstring
    has the policy). ``targets`` is a sequence of replica base URLs
    (``http://host:port`` or ``host:port``) or an object with a
    ``urls()`` method (:class:`~.pool.ReplicaPool`)."""

    def __init__(
        self,
        targets: Union[Sequence[str], object],
        *,
        retries: Optional[int] = None,
        poll_ms: Optional[float] = None,
        workers: Optional[int] = None,
        request_timeout: float = 30.0,
        retry_in_flight: bool = False,
        max_inflight: Optional[int] = None,
        slos: Optional[Sequence] = None,
        priorities: Optional[Dict[str, float]] = None,
        endpoint_priorities: Optional[Dict[str, str]] = None,
        priority_queue_max: Optional[int] = None,
        hedge: Optional[bool] = None,
        hedge_delay_ms: Optional[float] = None,
        hedge_max_fraction: Optional[float] = None,
        hedge_min_samples: Optional[int] = None,
    ):
        if hasattr(targets, "urls"):
            targets = targets.urls()
        self._targets: List[_Target] = [_Target(u) for u in targets]
        if not self._targets:
            raise ValueError("router needs at least one replica url")
        # per-replica in-flight budget (the client half of the bounded
        # per-replica admission discipline): a worker holding a request
        # BLOCKS for a slot rather than piling more concurrency onto a
        # busy replica. None = unlimited.
        self.max_inflight = (
            None if max_inflight is None else max(1, int(max_inflight))
        )
        self._state = threading.Condition()
        self.retries = int(
            retries if retries is not None
            else knobs.get("HEAT_TPU_SERVE_NET_RETRIES")
        )
        poll_ms = (
            poll_ms if poll_ms is not None
            else knobs.get("HEAT_TPU_SERVE_NET_POLL_MS")
        )
        self.poll_interval = max(0.001, float(poll_ms) / 1e3)
        self.request_timeout = float(request_timeout)
        self.retry_in_flight = bool(retry_in_flight)
        n_workers = (
            workers if workers is not None
            else max(8, 4 * len(self._targets))
        )
        self._stats: Dict[str, EndpointStats] = {}
        self._stats_lock = threading.Lock()
        # priority classes and weighted-fair admission
        self._weights = (
            dict(priorities) if priorities is not None
            else _parse_weights(knobs.get("HEAT_TPU_SERVE_PRIORITY_WEIGHTS"))
        )
        self.endpoint_priorities = dict(endpoint_priorities or {})
        self.priority_queue_max = int(
            priority_queue_max if priority_queue_max is not None
            else knobs.get("HEAT_TPU_SERVE_PRIORITY_QUEUE_MAX")
        )
        self._queue = _FairQueue(self._weights)
        self._class_counts: Dict[str, Dict[str, int]] = {}
        # hedged retries
        self.hedge = bool(
            hedge if hedge is not None else knobs.get("HEAT_TPU_HEDGE_ENABLE")
        )
        self.hedge_delay_ms = float(
            hedge_delay_ms if hedge_delay_ms is not None
            else knobs.get("HEAT_TPU_HEDGE_DELAY_MS")
        )
        self.hedge_max_fraction = float(
            hedge_max_fraction if hedge_max_fraction is not None
            else knobs.get("HEAT_TPU_HEDGE_MAX_FRACTION")
        )
        self.hedge_min_samples = int(
            hedge_min_samples if hedge_min_samples is not None
            else knobs.get("HEAT_TPU_HEDGE_MIN_SAMPLES")
        )
        self._closed = False
        # declared SLOs (telemetry.cluster.SLO), scored by cluster_summary()
        self.slos = list(slos) if slos else []
        self._slo_snaps: List[tuple] = []  # (mono, scrape state)
        self._slo_lock = threading.Lock()
        self.window_start = time.monotonic()
        self._counts = {"requests": 0, "retries": 0, "evictions": 0,
                        "readds": 0, "failed": 0, "shed": 0,
                        "hedges": 0, "hedge_wins": 0, "priority_sheds": 0}
        self._counts_lock = threading.Lock()
        self._local = threading.local()  # per-worker connection cache
        self._poll_conns: Dict[str, http.client.HTTPConnection] = {}
        self._workers = [
            threading.Thread(
                target=self._work, name=f"heat_tpu_torch.serve.net.router-{i}",
                daemon=True,
            )
            for i in range(int(n_workers))
        ]
        for t in self._workers:
            t.start()
        self._poll_thread = threading.Thread(
            target=self._poll_loop, name="heat_tpu_torch.serve.net.router-poll",
            daemon=True,
        )
        self._poll_thread.start()

    # -- client surface ------------------------------------------------------

    def submit(
        self, name: str, payload, *, priority: Optional[str] = None,
    ) -> Future:
        """Enqueue one request; the future resolves to the result rows,
        or to :class:`ServerOverloadedError` (every candidate shed, or
        the bounded router queue shed it by priority),
        :class:`ReplicaDownError` (no healthy replica / in-flight drop),
        or the upstream error. ``priority`` overrides the endpoint's
        configured class for this one request."""
        if self._closed:
            raise ServerClosedError("router is closed")
        # trace ingress: the sampling verdict is made HERE,
        # once, and rides the wire — replicas adopt, never re-mint
        ctx = tracing.mint("router.submit")
        cls = (
            priority or self.endpoint_priorities.get(name) or "default"
        )
        job = _Job(
            name,
            wire.encode_request(
                np.asarray(payload),
                trace=ctx.to_wire() if ctx is not None else None,
            ),
            ctx,
            cls=cls,
            weight=self._queue.weight(cls),
        )
        self._ep_stats(name).record_request(
            int(np.asarray(payload).shape[0])
            if np.asarray(payload).ndim else 1
        )
        self._class_count(cls, "submitted")
        # bounded weighted-fair admission: past the queue bound, the
        # NEWEST job of the lowest-weight queued class sheds first; an
        # incoming job at (or below) the bottom queued priority sheds
        # itself — shed order is priority-aware, never FIFO-blind
        if (
            self.priority_queue_max > 0
            and self._queue.qsize() >= self.priority_queue_max
        ):
            victim = self._queue.shed_lowest(job.weight)
            if victim is None:
                self._shed_priority(job)
                return job.future
            self._shed_priority(victim)
        self._queue.put(job)
        return job.future

    def set_priority(self, endpoint: str, cls: str) -> None:
        """Bind ``endpoint`` to priority class ``cls`` (per-request
        ``submit(priority=...)`` still overrides)."""
        self.endpoint_priorities[str(endpoint)] = str(cls)

    def _class_count(self, cls: str, key: str, n: int = 1) -> None:
        with self._counts_lock:
            row = self._class_counts.setdefault(
                cls, {"submitted": 0, "routed": 0, "shed": 0}
            )
            row[key] += n

    def _shed_priority(self, job: _Job) -> None:
        """Resolve one job as priority-shed (the bounded-queue path)."""
        st = self._ep_stats(job.endpoint)
        st.record_shed()
        self._count("shed")
        self._count("priority_sheds")
        self._class_count(job.cls, "shed")
        _emit("router", "priority_shed", endpoint=job.endpoint,
              cls=job.cls)
        try:
            job.future.set_exception(ServerOverloadedError(
                f"router queue is full ({self.priority_queue_max} "
                f"pending); class {job.cls!r} (weight "
                f"{job.weight:g}) shed by priority order",
                reason="priority_shed", endpoint=job.endpoint,
            ))
        except Exception:
            pass

    def predict(self, name: str, payload, timeout: Optional[float] = 30.0):
        """Synchronous convenience: ``submit(...).result(timeout)``."""
        return self.submit(name, payload).result(timeout)

    def add_target(self, url: str) -> None:
        """Join a new replica into the rotation (scale-up / re-add of a
        freshly spawned process)."""
        t = _Target(url)
        with self._state:
            if any(x.url == t.url for x in self._targets):
                return
            self._targets.append(t)
            self._state.notify_all()

    def remove_target(self, url: str) -> bool:
        """Administratively take a replica out of rotation (scale-down,
        dead-replica replacement). Unlike eviction the
        poll thread stops probing it — it will not be re-added. Returns
        whether the url was present. In-flight requests to it finish on
        their own (the drain half of scale-down is the pool's SIGTERM)."""
        canonical = _Target(url).url
        removed = None
        with self._state:
            for i, t in enumerate(self._targets):
                if t.url == canonical:
                    removed = self._targets.pop(i)
                    break
            self._state.notify_all()
        if removed is None:
            return False
        conn = self._poll_conns.pop(canonical, None)
        if conn is not None:
            try:
                conn.close()
            except Exception:
                pass
        _emit("router", "detach", replica=canonical)
        return True

    def stats(self) -> dict:
        """Loadgen-compatible aggregates: per-endpoint latency stats
        (client-observed submit→resolve), per-replica routing state, and
        the router counters."""
        with self._counts_lock:
            counts = dict(self._counts)
            class_counts = {
                c: dict(row) for c, row in self._class_counts.items()
            }
        with self._stats_lock:  # first-seen endpoints insert concurrently
            stats_items = list(self._stats.items())
        return {
            "endpoints": {n: s.snapshot() for n, s in stats_items},
            "queue_depth": self._queue.qsize(),
            # scrape contract: cumulative-since-window_start
            # counters + a monotonic stamp, so two scrapes derive rates
            # on their own side without racing any reset
            "window_start": self.window_start,
            "mono": time.monotonic(),
            "slos": [s.describe() for s in self.slos],
            "replicas": {
                t.url: {
                    "up": t.up,
                    "score": t.score(),
                    "inflight": t.inflight,
                    "polled_pending": t.polled_pending,
                    "evictions": t.evictions,
                    "suspect": t.suspect,
                }
                for t in list(self._targets)
            },
            "router": counts,
            "priority": {
                "weights": dict(self._weights),
                "queue_max": self.priority_queue_max,
                "classes": {
                    c: dict(row) for c, row in class_counts.items()
                },
            },
            "closed": self._closed,
        }

    # -- fleet observability ------------------------------------------------

    def _ops_get_once(self, target: _Target, path: str):
        """GET over a dedicated short-lived connection → ``(status,
        body)``. The keep-alive poll connections are poll-thread-only;
        observability scrapes run on caller threads and must not share
        them."""
        conn = _NoDelayConnection(
            target.host, target.port, timeout=_POLL_TIMEOUT
        )
        try:
            conn.request("GET", path)
            resp = conn.getresponse()
            return resp.status, resp.read()
        finally:
            conn.close()

    def _ops_get(self, target: _Target, path: str):
        """Hardened ops-plane GET: one retry when the
        resilience classifier calls the failure transient (connection
        resets/aborts — a mid-scrape restart, not an outage); a target
        that still fails is marked ``suspect`` (flag + event) so the
        failure is never a silent ``None`` entry. Success clears the
        flag."""
        from ...resilience.guard import classify

        try:
            out = self._ops_get_once(target, path)
        except Exception as e:
            if classify(e) != "transient":
                self._mark_suspect(target, path, e)
                raise
            try:
                out = self._ops_get_once(target, path)
            except Exception as e2:
                self._mark_suspect(target, path, e2)
                raise
        self._clear_suspect(target)
        return out

    def _mark_suspect(self, target: _Target, path: str, exc) -> None:
        with self._state:
            already = target.suspect
            target.suspect = True
        if not already:
            _emit("router", "suspect", replica=target.url, path=path,
                  error=repr(exc)[:200])

    def _clear_suspect(self, target: _Target) -> None:
        if target.suspect:
            with self._state:
                target.suspect = False

    def scrape_metrics(self) -> Dict[str, Optional[dict]]:
        """Pull ``GET /metrics`` from every replica → ``{url: payload}``
        (``None`` for replicas that failed to answer — merged summaries
        report them as ``scrape_failures``, never silently drop them)."""
        out: Dict[str, Optional[dict]] = {}
        for t in list(self._targets):
            try:
                status, body = self._ops_get(t, "/metrics")
                out[t.url] = (
                    json.loads(body.decode()) if status == 200 else None
                )
            except Exception:
                out[t.url] = None
        return out

    def scrape_traces(self) -> Dict[str, Optional[dict]]:
        """Pull ``GET /trace`` (each replica's in-memory telemetry
        events) → ``{url: {"pid", "wall", "events"} | None}``."""
        out: Dict[str, Optional[dict]] = {}
        for t in list(self._targets):
            try:
                status, body = self._ops_get(t, "/trace")
                out[t.url] = (
                    json.loads(body.decode()) if status == 200 else None
                )
            except Exception:
                out[t.url] = None
        return out

    def clock_sync(self, probes: int = 3) -> Dict[str, dict]:
        """Calibrate each replica's wall-clock offset against this process
        via the ``/healthz`` round trip: of ``probes`` exchanges on one
        keep-alive connection, take the minimum-RTT sample and estimate
        ``offset = remote_wall - rtt_midpoint`` with ``uncertainty =
        rtt / 2`` (the remote stamp happened somewhere inside the round
        trip). Returns ``{url: {"offset", "uncertainty", "rtt", "pid"}}``
        — replicas with no ``wall`` in /healthz are omitted."""
        from ...resilience.guard import classify

        def _probe(t: _Target):
            best = None
            pid = None
            conn = _NoDelayConnection(
                t.host, t.port, timeout=_POLL_TIMEOUT
            )
            try:
                for _ in range(max(1, int(probes))):
                    a = time.time()
                    conn.request("GET", "/healthz")
                    resp = conn.getresponse()
                    body = resp.read()
                    b = time.time()
                    payload = json.loads(body.decode())
                    wall = payload.get("wall")
                    if wall is None:
                        break
                    pid = payload.get("pid")
                    rtt = b - a
                    if best is None or rtt < best[0]:
                        best = (rtt, float(wall) - (a + b) / 2.0)
            finally:
                conn.close()
            return best, pid

        out: Dict[str, dict] = {}
        for t in list(self._targets):
            # same hardening as _ops_get: one retry on a transient
            # reset, suspect flag on persistent failure — never a
            # silently missing calibration entry
            try:
                best, pid = _probe(t)
            except Exception as e:
                if classify(e) != "transient":
                    self._mark_suspect(t, "/healthz", e)
                    continue
                try:
                    best, pid = _probe(t)
                except Exception as e2:
                    self._mark_suspect(t, "/healthz", e2)
                    continue
            self._clear_suspect(t)
            if best is not None:
                out[t.url] = {
                    "offset": best[1],
                    "uncertainty": best[0] / 2.0,
                    "rtt": best[0],
                    "pid": pid,
                }
        return out

    def cluster_summary(self) -> dict:
        """Scrape every replica and return the fleet-merged report
        (:func:`heat_tpu_torch.telemetry.cluster.summarize_cluster`): fleet
        QPS and exactly merged p50/p95/p99 per endpoint, per-replica rows
        and, when this router declares SLOs, the ``slo`` burn-rate block.
        Burn windows roll over ``HEAT_TPU_SLO_WINDOW_S``: each call diffs
        against the scrape taken about one window ago (the first call
        covers each replica's lifetime)."""
        from ...telemetry import cluster as _cluster

        scrapes = self.scrape_metrics()
        now = time.monotonic()
        window_s = float(knobs.get("HEAT_TPU_SLO_WINDOW_S"))
        with self._slo_lock:
            cutoff = now - max(0.001, window_s)
            # keep the newest snapshot at or before the cutoff as the
            # window's far edge; anything older is garbage
            while len(self._slo_snaps) >= 2 and self._slo_snaps[1][0] <= cutoff:
                self._slo_snaps.pop(0)
            prev = self._slo_snaps[0][1] if self._slo_snaps else None
        summary = _cluster.summarize_cluster(scrapes, slos=self.slos, prev_state=prev,
                                             router_stats=self.stats())
        with self._slo_lock:
            self._slo_snaps.append((now, summary["state"]))
        return summary

    def check_slos(self) -> List[dict]:
        """One SLO accounting pass: :meth:`cluster_summary`'s ``slo`` block,
        with an ``slo_burn`` telemetry event for every breach (burn rate
        above ``HEAT_TPU_SLO_BURN_THRESHOLD``)."""
        rows = self.cluster_summary().get("slo", [])
        for row in rows:
            if row.get("breach"):
                _emit("slo", "slo_burn", endpoint=row["endpoint"], burn_rate=row["burn_rate"],
                      threshold=row["threshold"], window_requests=row["window_requests"],
                      window_seconds=row["window_seconds"])
        return rows

    def prometheus_text(self) -> str:
        """The merged fleet view in Prometheus text exposition format
        (scrape the router once instead of N replicas)."""
        from ...telemetry import cluster as _cluster

        return _cluster.prometheus_text(self.cluster_summary())

    def export_cluster_trace(self, path: str) -> str:
        """Export ONE merged Perfetto trace: this router's events plus every
        replica's (``GET /trace``), clock offsets corrected by the
        ``/healthz`` calibration, one pid a replica, one fleet-wide t=0
        (:func:`heat_tpu_torch.telemetry.cluster.export_merged_trace`)."""
        from ...telemetry import cluster as _cluster

        return _cluster.export_merged_trace(self, path)

    def close(self) -> None:
        """Stop workers + poll thread; fail queued requests with
        :class:`ServerClosedError`. Idempotent."""
        if self._closed:
            return
        self._closed = True
        with self._state:
            self._state.notify_all()  # wake workers blocked on a slot
        # the queued requests fail before the workers' stop marks go in
        # behind them (the queue is first in, first out)
        while True:
            try:
                job = self._queue.get_nowait()
            except Empty:
                break
            if job is None:
                continue
            try:
                job.future.set_exception(
                    ServerClosedError("router closed with request pending")
                )
            except Exception:
                pass
        for _ in self._workers:
            self._queue.put(None)
        for t in self._workers:
            t.join(5.0)
        self._poll_thread.join(5.0)
        for conn in self._poll_conns.values():
            try:
                conn.close()
            except Exception:
                pass
        self._poll_conns.clear()

    def __enter__(self) -> "Router":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    # -- internals -----------------------------------------------------------

    def _ep_stats(self, name: str) -> EndpointStats:
        st = self._stats.get(name)
        if st is None:
            with self._stats_lock:
                st = self._stats.setdefault(name, EndpointStats(name))
        return st

    def _count(self, key: str, n: int = 1) -> None:
        with self._counts_lock:
            self._counts[key] += n

    def _pick_locked(self, exclude: set):
        """(best-free-target, any-up-but-at-budget) under ``_state``."""
        best, best_score, busy = None, None, False
        for t in self._targets:
            if not t.up or t.url in exclude:
                continue
            if (
                self.max_inflight is not None
                and t.inflight >= self.max_inflight
            ):
                busy = True
                continue
            s = t.score()
            if best_score is None or s < best_score:
                best, best_score = t, s
        return best, busy

    def _acquire(self, exclude: set, deadline: float):
        """Claim an in-flight slot on the least-loaded eligible replica;
        blocks while every eligible replica is at its in-flight budget.
        Returns ``(target, None)``, or ``(None, "down")`` when no healthy
        replica exists (fail fast), or ``(None, "timeout")`` when the
        request's deadline passed while waiting for a slot."""
        with self._state:
            while True:
                best, busy = self._pick_locked(exclude)
                if best is not None:
                    best.inflight += 1
                    return best, None
                if not busy or self._closed:
                    return None, "down"
                if time.perf_counter() >= deadline:
                    return None, "timeout"
                self._state.wait(
                    max(0.001, min(0.1, deadline - time.perf_counter()))
                )

    def _release(self, target: _Target) -> None:
        with self._state:
            target.inflight -= 1
            self._state.notify()

    def _try_acquire(self, exclude: set) -> Optional[_Target]:
        """Non-blocking slot claim (the hedge arm): the least-loaded
        eligible replica, or ``None`` — a hedge must never queue behind
        the very congestion it is trying to route around."""
        with self._state:
            best, _busy = self._pick_locked(exclude)
            if best is not None:
                best.inflight += 1
            return best

    # -- hedged retries ------------------------------------------------------

    def _hedge_delay_s(self, endpoint: str) -> Optional[float]:
        """Seconds to wait before duplicating a straggler: the explicit
        knob when set, else the endpoint's observed p95 once enough
        samples exist (``None`` = don't hedge yet)."""
        if self.hedge_delay_ms > 0:
            return self.hedge_delay_ms / 1e3
        snap = self._ep_stats(endpoint).snapshot().get("latency", {})
        if snap.get("count", 0) < self.hedge_min_samples:
            return None
        return snap.get("p95_s")

    def _hedge_budget_ok(self) -> bool:
        """Hard cap: hedges stay at/below ``hedge_max_fraction`` of
        completed requests (budget is earned by traffic — a cold router
        never hedges its first 1/fraction requests)."""
        with self._counts_lock:
            return (
                self._counts["hedges"] + 1
                <= self.hedge_max_fraction
                * max(1.0, float(self._counts["requests"]))
            )

    def _hedged_post(
        self, primary: _Target, path: str, job: _Job, delay_s: float,
        deadline: float,
    ):
        """POST to ``primary``; if no response lands within ``delay_s``,
        duplicate to the least-loaded sibling and take the FIRST HTTP
        response (any status — a fast 503 still wins and rides the
        normal retry ladder). The loser is canceled by closing its
        connection. Each arm runs on its own fresh connection (a shared
        keep-alive conn cannot be closed from another thread safely).

        Returns ``(status, body, winner_target)``. When every launched
        arm fails, re-raises the PRIMARY arm's failure under the
        dispatch taxonomy (ConnectionError-family / _InFlightDrop /
        _ResponseTimeout) so eviction/retry semantics are unchanged."""
        results: "_queue_mod.Queue" = _queue_mod.Queue()
        conns: Dict[str, _NoDelayConnection] = {}

        def _attempt(tag: str, tgt: _Target) -> None:
            conn = _NoDelayConnection(
                tgt.host, tgt.port, timeout=self.request_timeout
            )
            conns[tag] = conn
            sent = False
            try:
                conn.request(
                    "POST", path, body=job.body,
                    headers={"Content-Type": "application/json"},
                )
                sent = True
                resp = conn.getresponse()
                results.put((tag, tgt, "ok", (resp.status, resp.read())))
            except Exception as e:  # noqa: BLE001 — classified below
                if not sent:
                    kind = "conn"
                elif isinstance(e, TimeoutError):
                    kind = "timeout"
                else:
                    kind = "drop"
                results.put((tag, tgt, kind, e))
            finally:
                try:
                    conn.close()
                except Exception:
                    pass

        threading.Thread(
            target=_attempt, args=("primary", primary), daemon=True,
            name="heat_tpu_torch.serve.net.router-hedge-primary",
        ).start()
        launched = {"primary"}
        hedge_target: Optional[_Target] = None
        first = None
        try:
            wait = max(0.0, min(delay_s, deadline - time.perf_counter()))
            try:
                first = results.get(timeout=wait)
            except Empty:
                pass
            if first is None and time.perf_counter() < deadline:
                # primary is straggling: duplicate to a sibling if one
                # has a free slot right now
                hedge_target = self._try_acquire({primary.url})
                if hedge_target is not None:
                    launched.add("hedge")
                    self._count("hedges")
                    _emit("router", "hedge", endpoint=job.endpoint,
                          primary=primary.url, sibling=hedge_target.url)
                    threading.Thread(
                        target=_attempt, args=("hedge", hedge_target),
                        daemon=True,
                        name="heat_tpu_torch.serve.net.router-hedge-secondary",
                    ).start()
            failures: Dict[str, tuple] = {}
            received = 1 if first is not None else 0
            winner = None
            while winner is None and (
                first is not None or received < len(launched)
            ):
                if first is not None:
                    tag, tgt, kind, payload = first
                    first = None
                else:
                    try:
                        item = results.get(
                            timeout=max(
                                0.0, deadline - time.perf_counter()
                            )
                        )
                    except Empty:
                        break
                    received += 1
                    tag, tgt, kind, payload = item
                if kind == "ok":
                    winner = (tag, tgt, payload)
                else:
                    failures[tag] = (kind, payload)
            if winner is not None:
                tag, tgt, (status, data) = winner
                # first-wins: cancel the loser by closing its socket
                # (its thread errors out; the result is discarded)
                for other in launched - {tag} - set(failures):
                    oc = conns.get(other)
                    if oc is not None:
                        try:
                            oc.close()
                        except Exception:
                            pass
                if tag == "hedge":
                    self._count("hedge_wins")
                    _emit("router", "hedge_win", endpoint=job.endpoint,
                          replica=tgt.url)
                return status, data, tgt
            # no arm produced a response: surface the primary's failure
            # under the normal taxonomy (deadline with a silent primary
            # is the slow-not-dead case)
            kind, exc = failures.get("primary", (None, None))
            if kind == "conn":
                raise exc
            if kind == "drop":
                raise _InFlightDrop(repr(exc)) from exc
            raise _ResponseTimeout(
                f"no hedge arm answered within the deadline "
                f"({self.request_timeout}s)"
                if exc is None else repr(exc)
            ) from exc
        finally:
            if hedge_target is not None:
                self._release(hedge_target)

    def _evict(self, target: _Target, why: str) -> None:
        with self._state:
            if not target.up:
                return
            target.up = False
            target.evictions += 1
            target.poll_fails = 0
            self._state.notify_all()
        self._count("evictions")
        _emit("router", "evict", replica=target.url, reason=why)

    def _readd(self, target: _Target) -> None:
        with self._state:
            if target.up:
                return
            target.up = True
            target.polled_pending = 0
            self._state.notify_all()
        self._count("readds")
        _emit("router", "readd", replica=target.url)

    # one keep-alive connection per (worker thread, replica)
    def _conn(self, target: _Target, fresh: bool = False):
        cache = getattr(self._local, "conns", None)
        if cache is None:
            cache = self._local.conns = {}
        conn = cache.get(target.url)
        if conn is not None and conn.sock is not None and _dropped(conn.sock):
            fresh = True  # the replica closed this idle connection
        if fresh and conn is not None:
            try:
                conn.close()
            except Exception:
                pass
            conn = None
        if conn is None:
            conn = _NoDelayConnection(
                target.host, target.port, timeout=self.request_timeout
            )
            cache[target.url] = conn
        return conn

    def _post(self, target: _Target, path: str, body: bytes):
        """POST once; returns ``(status, body_bytes)``. Raises
        ``ConnectionError``-family when the request never made it onto
        an accepted connection (safe to retry a sibling),
        :class:`_InFlightDrop` when the connection died after the send
        (ambiguous — the request may have executed)."""
        conn = self._conn(target)
        reused = conn.sock is not None
        try:
            conn.request(
                "POST", path, body=body,
                headers={"Content-Type": "application/json"},
            )
        except Exception:
            conn.close()
            if not reused:
                raise  # fresh connect failed: replica is unreachable
            # keep-alive race: the server closed the idle conn under us
            # and the send never happened — one fresh-connection resend
            conn = self._conn(target, fresh=True)
            conn.request(
                "POST", path, body=body,
                headers={"Content-Type": "application/json"},
            )
        try:
            resp = conn.getresponse()
            data = resp.read()
            return resp.status, data
        except TimeoutError as e:  # socket.timeout: slow, not dead
            conn.close()
            raise _ResponseTimeout(repr(e)) from e
        except Exception as e:
            conn.close()
            raise _InFlightDrop(repr(e)) from e

    def _work(self) -> None:
        while True:
            job = self._queue.get()
            if job is None:
                return
            try:
                self._dispatch(job)
            except Exception as e:  # noqa: BLE001 — never kill a worker
                try:
                    job.future.set_exception(e)
                except Exception:
                    pass

    def _dispatch(self, job: _Job) -> None:
        st = self._ep_stats(job.endpoint)
        if job.ctx is not None:
            # router.queue: ingress -> a worker picked the job up. The
            # ingress=True flag pairs this span 1:1 with the sampled
            # mint, the live/offline reconciliation hook.
            now_wall = time.time()
            tracing.hop(
                "router.queue", (job.ctx,), job.t_wall,
                max(0.0, now_wall - job.t_wall), ingress=True,
                endpoint=job.endpoint,
            )
        path = f"/v1/{job.endpoint}"
        tried: set = set()
        attempts = 1 + max(0, self.retries)
        shed_reasons: List[str] = []
        down: List[str] = []
        deadline = job.t0 + self.request_timeout
        while len(tried) < attempts:
            target, why = self._acquire(tried, deadline)
            if target is None:
                if why == "timeout":
                    # every eligible replica stayed at its in-flight
                    # budget for the whole deadline — overload, not
                    # outage: shed 503-style
                    shed_reasons.append("router_timeout")
                break
            tried.add(target.url)
            t_post_wall = time.time() if job.ctx is not None else 0.0
            via = target
            try:
                hedge_delay = None
                if (
                    self.hedge
                    and len(tried) == 1
                    and self._hedge_budget_ok()
                ):
                    hedge_delay = self._hedge_delay_s(job.endpoint)
                if hedge_delay is not None:
                    status, data, via = self._hedged_post(
                        target, path, job, hedge_delay, deadline
                    )
                else:
                    status, data = self._post(target, path, job.body)
            except _ResponseTimeout as e:
                # the replica is healthy but did not answer in time —
                # 504-analog: no eviction (one slow request must not
                # bounce a live replica), no retry (ambiguous: the
                # request may still execute)
                st.record_error()
                self._count("failed")
                _emit("router", "failed", replica=target.url,
                      endpoint=job.endpoint, reason="timeout")
                job.future.set_exception(ServeError(
                    f"replica {target.url} did not answer "
                    f"{job.endpoint!r} within {self.request_timeout}s: {e}"
                ))
                return
            except _InFlightDrop as e:
                self._evict(target, "in_flight_drop")
                if self.retry_in_flight:
                    self._count("retries")
                    _emit("router", "retry", replica=target.url,
                          endpoint=job.endpoint, reason="in_flight_drop")
                    continue
                st.record_error()
                self._count("failed")
                _emit("router", "failed", replica=target.url,
                      endpoint=job.endpoint, reason="in_flight_drop")
                job.future.set_exception(ReplicaDownError(
                    f"replica {target.url} dropped the connection with "
                    f"the request in flight: {e}"
                ))
                return
            except Exception:
                # connect-level failure: the replica never saw the
                # request — evict it and retry a sibling
                self._evict(target, "connect")
                down.append(target.url)
                self._count("retries")
                _emit("router", "retry", replica=target.url,
                      endpoint=job.endpoint, reason="connect")
                continue
            finally:
                self._release(target)
            if status == 200:
                try:
                    ok, result, _reason = wire.decode_response(data)
                    if not ok:
                        raise wire.WireError(
                            f"200 response carried ok=false: {result}"
                        )
                except wire.WireError as e:
                    st.record_error()
                    self._count("failed")
                    _emit("router", "failed", replica=target.url,
                          endpoint=job.endpoint, reason="wire")
                    job.future.set_exception(e)
                    return
                dt = time.perf_counter() - job.t0
                st.record_done(dt)
                self._count("requests")
                self._class_count(job.cls, "routed")
                _emit("router", "route", replica=via.url,
                      endpoint=job.endpoint, seconds=dt)
                if job.ctx is not None:
                    # router.post: the winning HTTP round trip (retries
                    # that shed/failed are visible as serve_net events)
                    tracing.hop(
                        "router.post", (job.ctx,), t_post_wall,
                        max(0.0, time.time() - t_post_wall),
                        endpoint=job.endpoint, replica=via.url,
                    )
                job.future.set_result(result)
                return
            ok, message, reason = _safe_decode(data)
            if status == 503:
                # sticky degradation: a shed (queue_full/memory/
                # draining/closed) retries siblings before failing
                shed_reasons.append(reason or "shed")
                if reason in ("draining", "closed"):
                    # the replica is leaving: no new request goes to it
                    # while it exits (the health poll re-adds it if its
                    # /healthz answers 200 again)
                    self._evict(via, reason)
                # priority-aware ladder: a shed request whose class sits
                # below queued higher-priority work yields its sibling
                # retries (bulk degrades first)
                top = self._queue.max_queued_weight()
                if top is not None and top > job.weight:
                    shed_reasons.append("priority_yield")
                    break
                _emit("router", "retry", replica=via.url,
                      endpoint=job.endpoint, reason=reason or "shed")
                self._count("retries")
                continue
            # 4xx/5xx: deterministic upstream verdict — do not retry
            st.record_error()
            self._count("failed")
            _emit("router", "failed", replica=target.url,
                  endpoint=job.endpoint, reason=reason or str(status))
            exc: Exception
            if status == 400 or status == 404:
                exc = ValueError(message or f"HTTP {status}")
            else:
                exc = ServeError(
                    f"replica {target.url} answered HTTP {status}: "
                    f"{message}"
                )
            job.future.set_exception(exc)
            return
        # retry ladder exhausted (or yielded by priority)
        if shed_reasons:
            st.record_shed()
            self._count("shed")
            self._class_count(job.cls, "shed")
            _emit("router", "shed", endpoint=job.endpoint,
                  reasons=shed_reasons[:4])
            job.future.set_exception(ServerOverloadedError(
                f"every tried replica shed the request "
                f"(reasons: {shed_reasons})",
                reason=shed_reasons[-1], endpoint=job.endpoint,
            ))
        else:
            st.record_error()
            self._count("failed")
            _emit("router", "failed", endpoint=job.endpoint,
                  reason="no_replicas")
            job.future.set_exception(ReplicaDownError(
                f"no healthy replica for {job.endpoint!r} "
                f"(down: {down or [t.url for t in self._targets]})"
            ))

    # -- background poll -----------------------------------------------------

    # one keep-alive poll connection per replica (poll-thread-only +
    # close(); default 25 ms ticks would otherwise open ~40 TCP
    # connections per replica per second)
    def _poll_conn(self, target: _Target, fresh: bool = False):
        conn = self._poll_conns.get(target.url)
        if fresh and conn is not None:
            try:
                conn.close()
            except Exception:
                pass
            conn = None
        if conn is None:
            conn = _NoDelayConnection(
                target.host, target.port, timeout=_POLL_TIMEOUT
            )
            self._poll_conns[target.url] = conn
        return conn

    def _poll_get(self, target: _Target, path: str):
        """GET over the cached poll connection → ``(status, body)``;
        one fresh-connection resend when a reused conn died idle."""
        conn = self._poll_conn(target)
        reused = conn.sock is not None
        try:
            conn.request("GET", path)
            resp = conn.getresponse()
            return resp.status, resp.read()
        except Exception:
            try:
                conn.close()
            except Exception:
                pass
            if not reused:
                self._poll_conns.pop(target.url, None)
                raise
            conn = self._poll_conn(target, fresh=True)
            try:
                conn.request("GET", path)
                resp = conn.getresponse()
                return resp.status, resp.read()
            except Exception:
                try:
                    conn.close()
                except Exception:
                    pass
                self._poll_conns.pop(target.url, None)
                raise

    def _poll_one(self, target: _Target) -> None:
        try:
            if target.up:
                _status, body = self._poll_get(target, "/stats")
                payload = json.loads(body.decode())
                with self._state:
                    target.polled_pending = int(
                        payload.get("pending", payload.get("queue_depth", 0))
                        or 0
                    )
                    target.poll_fails = 0
                    target.suspect = False  # it answered: not suspect
            else:
                status, _body = self._poll_get(target, "/healthz")
                if status == 200:
                    self._readd(target)
        except Exception:
            if target.up:
                with self._state:
                    target.poll_fails += 1
                    fails = target.poll_fails
                # two consecutive poll misses = gone (a single slow
                # poll under load must not bounce a healthy replica)
                if fails >= 2:
                    self._evict(target, "health_poll")

    def _poll_loop(self) -> None:
        while not self._closed:
            for target in list(self._targets):
                if self._closed:
                    return
                self._poll_one(target)
            time.sleep(self.poll_interval)


def _dropped(sock) -> bool:
    """Whether an idle keep-alive socket was closed by its peer: it reads
    as ready (end of stream) while no answer is due. Reusing it would send
    a request into a socket the replica no longer reads."""
    try:
        ready, _, _ = select.select([sock], [], [], 0)
    except (OSError, ValueError):
        return True
    return bool(ready)


def _parse_weights(spec: Optional[str]) -> Dict[str, float]:
    """Parse ``HEAT_TPU_SERVE_PRIORITY_WEIGHTS`` — ``"latency=8,bulk=1"``
    → ``{"latency": 8.0, "bulk": 1.0}``. Empty/unset = single implicit
    class (first in, first out)."""
    out: Dict[str, float] = {}
    for part in (spec or "").replace(";", ",").split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(
                f"priority weight {part!r} must be 'class=weight' "
                "(HEAT_TPU_SERVE_PRIORITY_WEIGHTS)"
            )
        k, v = part.split("=", 1)
        w = float(v)
        if w <= 0:
            raise ValueError(
                f"priority class {k.strip()!r} needs a positive weight, "
                f"got {w}"
            )
        out[k.strip()] = w
    return out


def _safe_decode(data: bytes) -> Tuple[bool, str, str]:
    try:
        ok, message, reason = wire.decode_response(data)
        return ok, str(message), reason
    except Exception:
        return False, data[:200].decode("utf-8", "replace"), ""
