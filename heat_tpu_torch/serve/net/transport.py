"""HTTP transport: one replica's network front.

Counterpart of ``heat_tpu/serve/net/transport.py``: a thin adapter on the
stdlib's ``ThreadingHTTPServer`` that turns wire requests (:mod:`.wire`)
into :meth:`heat_tpu_torch.serve.Server.submit` futures. The
micro-batcher coalesces across the handler threads as across in-process
callers, admission sheds before memory runs out, and the program registry
keeps the steady state at zero builds. Routes:

* ``POST /v1/<endpoint>``: decode, ``submit()``, wait, encode. A shed is
  **HTTP 503** with the machine ``reason`` (``queue_full``, ``memory``,
  ``draining``), a malformed payload 400, an unknown endpoint 404, a
  future's time-out 504, a failed batch 500;
* ``GET /healthz``: 200 while accepting, 503 while draining or closed,
  with ``wall``/``mono`` stamps for the router's clock sync;
* ``GET /stats``: :meth:`Server.stats` plus a ``net`` block: pid, port,
  draining, HTTP tallies, the warm-up report, the kernels this process
  compiled (``kernel_builds``), and ``steady_backend_compiles``, the
  builds a :class:`telemetry.CompileWatcher` armed at :meth:`start` (after
  the warm-up) has seen: the remote zero-build oracle;
* ``GET /metrics``: :meth:`Server.metrics`, the mergeable tallies;
* ``GET /trace``: this process's in-memory telemetry events.

Graceful shutdown: :meth:`HttpFront.drain` sheds new work 503-style
(with ``Connection: close``), lets queued and in-flight batches finish
(:meth:`Server.drain`), answers every request still arriving until none
has come for ``DRAIN_QUIET`` seconds, then stops the listener; the
replica's SIGTERM handler runs exactly that.
"""

from __future__ import annotations

import json
import os
import threading
import time
from concurrent.futures import TimeoutError as FutureTimeoutError
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from ... import _knobs as knobs
from ... import telemetry
from .. import tracing
from ..admission import ServerClosedError, ServerOverloadedError
from . import wire
from .events import emit as _emit

__all__ = ["HttpFront"]

DRAIN_QUIET = 0.1  # seconds without a POST before a draining front stops


class _NetHTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True
    # BaseHTTPRequestHandler writes status line / headers / body as
    # separate small sends; with Nagle on, the write-write-read pattern
    # stalls tens of ms per response on some kernels — measured 33 ms
    # round trips on loopback before this flag
    disable_nagle_algorithm = True
    front: "HttpFront"  # set by HttpFront.start


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"  # keep-alive: every response sets length

    # -- plumbing ------------------------------------------------------------

    def log_message(self, fmt, *args):  # noqa: D102 — silence per-request
        pass                            # stderr chatter (telemetry has it)

    def _send(self, code: int, body: bytes) -> None:
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        if self.server.front.draining:
            # a draining front closes each connection after its answer,
            # so no client reuses a keep-alive socket of a replica that
            # is about to exit
            self.send_header("Connection", "close")
            self.close_connection = True
        self.end_headers()
        try:
            self.wfile.write(body)
        except (BrokenPipeError, ConnectionResetError):
            pass  # client went away mid-response; nothing to salvage

    def _send_error(self, code: int, message: str, reason: str) -> None:
        self.server.front._count(code)
        self._send(code, wire.encode_error(message, reason))

    # -- routes --------------------------------------------------------------

    def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler contract
        front = self.server.front
        if self.path == "/healthz":
            accepting = front.accepting()
            # wall/mono ride the health probe so the router's clock-sync
            # round trip needs no extra route
            body = json.dumps(
                {"ok": accepting, "draining": front.draining,
                 "pid": front.pid, "wall": time.time(),
                 "mono": time.monotonic()}
            ).encode()
            self._send(200 if accepting else 503, body)
        elif self.path == "/stats":
            self._send(200, json.dumps(front.stats_payload()).encode())
        elif self.path == "/metrics":
            self._send(200, json.dumps(front.metrics_payload()).encode())
        elif self.path == "/trace":
            self._send(200, json.dumps(front.trace_payload()).encode())
        else:
            self._send_error(404, f"unknown path {self.path!r}", "not_found")

    def do_POST(self):  # noqa: N802
        front = self.server.front
        front._active(1)
        try:
            self._post(front)
        finally:
            front._active(-1)

    def _post(self, front) -> None:
        if not self.path.startswith("/v1/"):
            self._send_error(404, f"unknown path {self.path!r}", "not_found")
            return
        name = self.path[len("/v1/"):]
        endpoints = getattr(front.server, "endpoints", None)
        if endpoints is not None and name not in endpoints():
            # documented contract: a missing endpoint is 404 ("not
            # deployed on this replica"), distinct from 400 (bad payload)
            self._send_error(
                404, f"no endpoint {name!r} on this replica", "not_found"
            )
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
            payload, trace = wire.decode_request_ex(self.rfile.read(length))
        except wire.WireError as e:
            self._send_error(400, str(e), "bad_request")
            return
        # adopt the ingress's trace verdict (None when the field is
        # absent: sampling is decided once, at the ingress, and the
        # replica does not re-mint)
        ctx = tracing.from_wire(trace) if trace is not None else None
        try:
            # capture the version at submit: the server swaps endpoints
            # only between micro-batches, and a replica process mounts
            # exactly one checkpoint version for its whole life, so this
            # is the version that serves the request in a rolling deploy
            getv = getattr(front.server, "endpoint_version", None)
            version = getv(name) if getv is not None else None
            fut = front.server.submit(name, payload, trace=ctx)
            result = fut.result(front.request_timeout)
        except ServerOverloadedError as e:
            self._send_error(503, str(e), e.reason)
            return
        except ServerClosedError as e:
            self._send_error(503, str(e), "closed")
            return
        except FutureTimeoutError:
            self._send_error(
                504,
                f"endpoint {name!r} did not answer within "
                f"{front.request_timeout}s", "timeout",
            )
            return
        except ValueError as e:
            # unknown endpoint / wrong feature count — caller bug, 400
            self._send_error(400, str(e), "bad_request")
            return
        except Exception as e:  # noqa: BLE001 — a failed batch is data
            self._send_error(500, repr(e), "internal")
            return
        front._count(200)
        self._send(200, wire.encode_response(np.asarray(result), version=version))


class HttpFront:
    """One replica's HTTP listener over an existing
    :class:`heat_tpu_torch.serve.Server` (module docstring has the routes).
    ``port`` 0 (default, knob ``HEAT_TPU_SERVE_NET_PORT``) binds an
    ephemeral port; read :attr:`port` / :attr:`url` after
    :meth:`start`."""

    def __init__(
        self,
        server,
        *,
        host: str = "127.0.0.1",
        port: Optional[int] = None,
        request_timeout: float = 30.0,
    ):
        self.server = server
        self.host = host
        self.port = int(
            port if port is not None else knobs.get("HEAT_TPU_SERVE_NET_PORT")
        )
        self.kernel_builds: Optional[int] = None  # replica main fills this
        self.request_timeout = float(request_timeout)
        self.pid = os.getpid()
        self.warmup_report: Optional[dict] = None  # replica main fills this
        self._httpd: Optional[_NetHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._steady_cw: Optional[telemetry.CompileWatcher] = None
        self._lock = threading.Lock()
        self._http_by_code: dict = {}
        self._in_handler = 0  # POST handlers between request and answer
        self._last_post = 0.0  # monotonic time a POST handler last began or ended

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> int:
        """Bind + serve in a daemon thread; returns the bound port. Arms
        the steady-state CompileWatcher — call *after* ``warmup()`` so
        every later backend compile is a steady-state violation."""
        if self._httpd is not None:
            return self.port
        self._httpd = _NetHTTPServer((self.host, self.port), _Handler)
        self._httpd.front = self
        self.port = self._httpd.server_address[1]
        # held open for the front's lifetime: backend_compiles read by
        # /stats is the remote zero-compile oracle
        self._steady_cw = telemetry.CompileWatcher()
        self._steady_cw.__enter__()
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            kwargs={"poll_interval": 0.05},
            name="heat_tpu_torch.serve.net.http", daemon=True,
        )
        self._thread.start()
        _emit("http", "listen", port=self.port, pid=self.pid)
        return self.port

    def stop(self, timeout: float = 5.0) -> None:
        """Stop the listener (does not touch the serve.Server)."""
        httpd, self._httpd = self._httpd, None
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None
        if self._steady_cw is not None:
            self._steady_cw.__exit__(None, None, None)

    def drain(self, timeout: float = 30.0) -> bool:
        """Graceful shutdown: shed new submits 503/``draining`` (the
        router retries siblings), finish queued + in-flight batches,
        let every handler write its answer, then stop the listener.
        Returns ``Server.drain``'s verdict."""
        _emit("http", "drain", port=self.port, pid=self.pid)
        deadline = time.monotonic() + max(0.0, timeout)
        drained = self.server.drain(timeout)
        # answer every request already on its way: a router evicts a
        # replica at its first "draining" answer, so POSTs stop within a
        # round trip; stop once none has run for DRAIN_QUIET seconds
        while time.monotonic() < deadline and (
                self._in_handler or time.monotonic() - self._last_post < DRAIN_QUIET):
            time.sleep(0.005)
        self.stop()
        return drained

    def __enter__(self) -> "HttpFront":
        self.start()
        return self

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False

    # -- introspection -------------------------------------------------------

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    @property
    def draining(self) -> bool:
        return bool(getattr(self.server, "draining", False))

    def accepting(self) -> bool:
        return (
            self._httpd is not None
            and not self.draining
            and not getattr(self.server, "_closed", False)
        )

    def _active(self, delta: int) -> None:
        with self._lock:
            self._in_handler += delta
            self._last_post = time.monotonic()

    def _count(self, code: int) -> None:
        with self._lock:
            self._http_by_code[code] = self._http_by_code.get(code, 0) + 1

    def steady_backend_compiles(self) -> int:
        cw = self._steady_cw
        return cw.backend_compiles if cw is not None else 0

    def stats_payload(self) -> dict:
        """``GET /stats`` body: ``Server.stats()`` + the ``net`` block."""
        with self._lock:
            by_code = dict(self._http_by_code)
        stats = self.server.stats()
        stats["net"] = {
            "pid": self.pid,
            "port": self.port,
            "draining": self.draining,
            "http_requests": sum(by_code.values()),
            "http_by_code": {str(k): v for k, v in by_code.items()},
            "steady_backend_compiles": self.steady_backend_compiles(),
            "warmup": self.warmup_report,
            "kernel_builds": self.kernel_builds,
        }
        return stats

    def metrics_payload(self) -> dict:
        """``GET /metrics`` body: :meth:`Server.metrics` (raw mergeable
        tallies) + the replica identity/clock block scrapers key on."""
        getm = getattr(self.server, "metrics", None)
        out = getm() if getm is not None else {"endpoints": {}}
        out["net"] = {
            "pid": self.pid,
            "port": self.port,
            "draining": self.draining,
            "steady_backend_compiles": self.steady_backend_compiles(),
            "wall": time.time(),
            "mono": time.monotonic(),
        }
        return out

    def trace_payload(self) -> dict:
        """``GET /trace`` body: this process's in-memory telemetry
        events (empty when telemetry is off), stamped with pid + wall so
        the merged-trace exporter can label and clock-align the track."""
        reg = telemetry.get_registry()
        with reg._lock:
            events = [dict(ev) for ev in reg.events]
        return {"pid": self.pid, "wall": time.time(), "events": events}
