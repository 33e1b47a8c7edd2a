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

The JAX package's priority classes (weighted-fair admission) and hedged
retries go with its autoscaling controller (ROADMAP §1 item 14): the
port's router queues first in, first out, sends each attempt once, and
raises ``NotImplementedError`` when a priority or a hedge is asked for.

The client surface is the in-process server's: ``submit()`` returns a
future, ``predict()`` blocks, ``stats()["endpoints"]`` carries the same
per-endpoint aggregates. The fleet views of the JAX package
(``cluster_summary``, ``check_slos``, ``prometheus_text``,
``export_cluster_trace``) need ``telemetry.cluster`` and raise
``NotImplementedError`` until it is ported (ROADMAP §1 item 13).
"""

from __future__ import annotations

import http.client
import json
import queue as _queue_mod
import select
import threading
import time
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
_CLUSTER_TODO = ("Router.{} needs telemetry.cluster, not ported yet "
                 "(ROADMAP §1 item 13); scrape_metrics() gives the raw per-replica payloads")
_LATER_TODO = ("the router's {} is not ported yet: priority classes and hedged retries "
               "come with the autoscaling controller (ROADMAP §1 item 14)")
# the JAX router's keywords of those two features
_LATER_KWARGS = frozenset({"priorities", "endpoint_priorities", "priority_queue_max", "hedge",
                           "hedge_delay_ms", "hedge_max_fraction", "hedge_min_samples"})


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
    __slots__ = ("endpoint", "body", "future", "t0", "t_wall", "ctx")

    def __init__(self, endpoint: str, body: bytes, ctx=None):
        self.endpoint = endpoint
        self.body = body
        self.future: Future = Future()
        self.t0 = time.perf_counter()
        # wall twin of t0, trace-only (spans anchor on wall clock)
        self.t_wall = time.time() if ctx is not None else 0.0
        self.ctx = ctx  # Optional[tracing.TraceContext]


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
        **later,
    ):
        unknown = sorted(set(later) - _LATER_KWARGS)
        if unknown:
            raise TypeError(f"Router() got unexpected keyword arguments {unknown}")
        asked = sorted(k for k, v in later.items() if v is not None and v is not False)
        if asked:
            raise NotImplementedError(_LATER_TODO.format(", ".join(asked)))
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
        self._queue: _queue_mod.Queue = _queue_mod.Queue()
        self._closed = False
        # declared SLOs, kept for stats() (their burn-rate accounting
        # needs telemetry.cluster)
        self.slos = list(slos) if slos else []
        self.window_start = time.monotonic()
        self._counts = {"requests": 0, "retries": 0, "evictions": 0,
                        "readds": 0, "failed": 0, "shed": 0}
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
        or to :class:`ServerOverloadedError` (every candidate shed),
        :class:`ReplicaDownError` (no healthy replica / in-flight drop),
        or the upstream error. A ``priority`` raises
        ``NotImplementedError`` (module docstring)."""
        if priority is not None:
            raise NotImplementedError(_LATER_TODO.format("priority"))
        if self._closed:
            raise ServerClosedError("router is closed")
        # trace ingress: the sampling verdict is made HERE,
        # once, and rides the wire — replicas adopt, never re-mint
        ctx = tracing.mint("router.submit")
        job = _Job(
            name,
            wire.encode_request(
                np.asarray(payload),
                trace=ctx.to_wire() if ctx is not None else None,
            ),
            ctx,
        )
        self._ep_stats(name).record_request(
            int(np.asarray(payload).shape[0])
            if np.asarray(payload).ndim else 1
        )
        self._queue.put(job)
        return job.future

    def set_priority(self, endpoint: str, cls: str) -> None:
        """Priority classes are not ported yet: raises
        ``NotImplementedError`` (module docstring)."""
        raise NotImplementedError(_LATER_TODO.format("set_priority"))

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
        """The fleet-merged report of the JAX package
        (``telemetry.cluster.summarize_cluster``): not ported yet."""
        raise NotImplementedError(_CLUSTER_TODO.format("cluster_summary"))

    def check_slos(self) -> List[dict]:
        """One SLO burn-rate pass over :meth:`cluster_summary`: not ported
        yet."""
        raise NotImplementedError(_CLUSTER_TODO.format("check_slos"))

    def prometheus_text(self) -> str:
        """The merged fleet view in Prometheus text format: not ported yet."""
        raise NotImplementedError(_CLUSTER_TODO.format("prometheus_text"))

    def export_cluster_trace(self, path: str) -> str:
        """One merged Perfetto trace of the fleet: not ported yet."""
        raise NotImplementedError(_CLUSTER_TODO.format("export_cluster_trace"))

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
            try:
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
                _emit("router", "route", replica=target.url,
                      endpoint=job.endpoint, seconds=dt)
                if job.ctx is not None:
                    # router.post: the winning HTTP round trip (retries
                    # that shed/failed are visible as serve_net events)
                    tracing.hop(
                        "router.post", (job.ctx,), t_post_wall,
                        max(0.0, time.time() - t_post_wall),
                        endpoint=job.endpoint, replica=target.url,
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
                    self._evict(target, reason)
                _emit("router", "retry", replica=target.url,
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
        # retry ladder exhausted
        if shed_reasons:
            st.record_shed()
            self._count("shed")
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


def _safe_decode(data: bytes) -> Tuple[bool, str, str]:
    try:
        ok, message, reason = wire.decode_response(data)
        return ok, str(message), reason
    except Exception:
        return False, data[:200].decode("utf-8", "replace"), ""
