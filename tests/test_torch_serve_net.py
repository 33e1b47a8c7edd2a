"""``heat_tpu_torch.serve.net`` against ``heat_tpu.serve.net`` on the CPU.

- The wire: the port's bytes equal the JAX package's for every dtype,
  scalars, 1-D arrays, ``CsrRows`` requests, responses with and without a
  version, errors and the trace field; each package decodes the other's;
  garbage raises ``WireError``.
- ``HttpFront`` over a live server: the routes, answers equal to the
  in-process server bit for bit, the status mapping of submit's errors
  (503 with the shed reason, 400, 404, 500, 504), the drain; a JAX router
  reaches a port replica and a port router a JAX replica, bit for bit.
- ``Server.drain``: the backlog completes, new submits shed ``draining``.
- The router against scripted fake replicas (HTTP/1.0, one request a
  connection): sibling retries after a 503, every replica shedding, a
  refused connection evicted, an in-flight drop failed unless
  ``retry_in_flight``, a slow answer timed out without eviction, the
  health poll's eviction and re-add, a 4xx never retried, ``add_target``
  dedupes; a kept-alive connection the replica closed is not reused; the
  router over two live fronts spreads a burst bit for bit; the fleet
  views raise naming ROADMAP item 13; the events' counters are the JAX
  package's.
- One subprocess test (tier-1, not slow): two ``--device cpu`` replicas
  from a serve checkpoint, a router, answers bit for bit, zero builds after
  warm-up in each replica, then ``rolling_update`` onto the checkpoint of a
  ``Server.publish`` (version 2) under concurrent traffic: every request
  answered (by one version or the other, bit for bit), both drains exit 0,
  the versions advance. Each wait has its own time-out and the whole test
  must finish within 90 s (about 15 s here).
- A fresh interpreter that serves through the port (server, front,
  router, the replica module) holds no module of heat_tpu or jax.
"""

import http.client
import json
import os
import subprocess
import sys
import textwrap
import threading
import time
from pathlib import Path
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

import heat_tpu as ht_tpu
from heat_tpu.serve.net import HttpFront as JaxHttpFront
from heat_tpu.serve.net import Router as JaxRouter
from heat_tpu.serve.net import events as jax_events
from heat_tpu.serve.net import wire as jax_wire
from heat_tpu.sparse.host import CsrRows as JaxCsrRows

import heat_tpu_torch as htt
from heat_tpu_torch import serve, streaming
from heat_tpu_torch.serve import ServeError, Server, ServerClosedError, ServerOverloadedError
from heat_tpu_torch.serve.net import (EVENT_COUNTER, HttpFront, ReplicaDownError, ReplicaPool,
                                      Router, WireError, router as router_mod, wire)
from heat_tpu_torch.sparse.host import CsrRows


REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def on_cpu():
    htt.use_device("cpu")
    yield
    htt.use_device(None)


@pytest.fixture()
def rng():
    return np.random.default_rng(3)


def _ref():
    return np.random.default_rng(7).standard_normal((32, 8)).astype(np.float32)


def _cdist_server(**kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("max_wait_ms", 1.0)
    srv = Server(**kw)
    srv.register("cdist", serve.cdist_query(_ref()))
    return srv


def _wait_until(fn, timeout=10.0, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if fn():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


def _http(host, port, method, path, body=None, timeout=10.0):
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        conn.request(method, path, body=body)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


# -- the wire -------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "float64", "float16", "int64", "int32", "int8",
                                   "uint8", "uint64", "bool", "complex64"])
def test_wire_bytes_equal_the_jax_packages(rng, dtype):
    arr = (rng.standard_normal((3, 5)) * 4).astype(dtype)
    assert wire.encode_array(arr) == jax_wire.encode_array(arr)
    assert wire.encode_request(arr) == jax_wire.encode_request(arr)
    trace = {"id": "00000001000000aa", "parent": "router.submit", "sampled": True}
    assert wire.encode_request(arr, trace=trace) == jax_wire.encode_request(arr, trace=trace)
    for version in (None, 3):
        assert wire.encode_response(arr, version=version) == \
            jax_wire.encode_response(arr, version=version)
    back = wire.decode_array(jax_wire.encode_array(arr))
    assert back.dtype == arr.dtype and back.tobytes() == arr.tobytes()
    theirs = jax_wire.decode_array(wire.encode_array(arr))
    assert theirs.dtype == arr.dtype and theirs.tobytes() == arr.tobytes()


def test_wire_scalars_views_csr_and_errors(rng):
    for arr in (np.float32(3.25), np.int64(-7), rng.standard_normal(7), np.zeros((0, 4)),
                rng.standard_normal((6, 4))[:, ::2], np.asfortranarray(rng.random((3, 2)))):
        a = np.asarray(arr)
        assert wire.encode_array(a) == jax_wire.encode_array(a)
        assert wire.decode_array(wire.encode_array(a)).tobytes() == np.ascontiguousarray(a).tobytes()
    dense = rng.standard_normal((4, 9)).astype(np.float32)
    dense[rng.random(dense.shape) < 0.5] = 0
    mine, theirs = CsrRows.from_dense(dense), JaxCsrRows.from_dense(dense)
    assert wire.encode_request(mine) == jax_wire.encode_request(theirs)
    got = wire.decode_request(jax_wire.encode_request(theirs))
    assert isinstance(got, CsrRows) and np.array_equal(got.to_dense(), dense)
    assert wire.encode_error("queue is full", "queue_full") == \
        jax_wire.encode_error("queue is full", "queue_full")
    ok, message, reason = wire.decode_response(jax_wire.encode_error("full", "queue_full"))
    assert (ok, message, reason) == (False, "full", "queue_full")
    assert wire.decode_response_version(jax_wire.encode_response(dense, version=5)) == 5
    assert wire.decode_response_version(wire.encode_error("x", "y")) is None
    payload, trace = wire.decode_request_ex(jax_wire.encode_request(dense, trace={"id": "a"}))
    assert trace == {"id": "a"} and payload.tobytes() == dense.tobytes()
    import base64

    for bad in ("not base64!!", base64.b64encode(b"not an npy blob").decode(), 12345):
        with pytest.raises(WireError):
            wire.decode_array(bad)
    for body in (b"not json", b'{"nope": 1}', b'{"payload_csr": {"indptr": 1}}'):
        with pytest.raises(WireError):
            wire.decode_request(body)
    with pytest.raises(WireError):
        wire.decode_response(b'{"no_ok_field": 1}')
    with pytest.raises(WireError):
        wire.encode_array(np.array([object()], dtype=object))


def test_event_counters_are_the_jax_packages():
    assert EVENT_COUNTER == jax_events.EVENT_COUNTER


# -- HttpFront ------------------------------------------------------------------------


def test_front_routes_and_bit_identity(rng):
    q = rng.standard_normal((3, 8)).astype(np.float32)
    with _cdist_server() as srv:
        srv.warmup()
        want = srv.predict("cdist", q)
        with HttpFront(srv, port=0) as front:
            status, body = _http(front.host, front.port, "GET", "/healthz")
            assert status == 200 and json.loads(body)["ok"]
            status, body = _http(front.host, front.port, "POST", "/v1/cdist",
                                 wire.encode_request(q))
            ok, got, _ = wire.decode_response(body)
            assert status == 200 and ok and got.tobytes() == want.tobytes()
            assert wire.decode_response_version(body) == 1
            st = json.loads(_http(front.host, front.port, "GET", "/stats")[1])
            assert st["net"]["port"] == front.port
            assert st["net"]["steady_backend_compiles"] == 0
            assert st["net"]["http_requests"] >= 1 and "cdist" in st["endpoints"]
            assert st["programs"]["misses"] >= len(srv.ladder)
            metrics = json.loads(_http(front.host, front.port, "GET", "/metrics")[1])
            assert metrics["endpoints"]["cdist"]["requests"] >= 2
            assert json.loads(_http(front.host, front.port, "GET", "/trace")[1])["pid"] == os.getpid()
            assert _http(front.host, front.port, "GET", "/nope")[0] == 404
            status, body = _http(front.host, front.port, "POST", "/v1/missing",
                                 wire.encode_request(q))
            assert status == 404 and json.loads(body)["reason"] == "not_found"
            status, body = _http(front.host, front.port, "POST", "/v1/cdist", b"not json")
            assert status == 400 and json.loads(body)["reason"] == "bad_request"


def test_front_status_mapping():
    class _Stub:
        draining = False
        _closed = False
        behavior = "ok"

        def submit(self, name, payload, trace=None):
            if self.behavior == "queue_full":
                raise ServerOverloadedError("full", reason="queue_full", endpoint=name)
            if self.behavior == "closed":
                raise ServerClosedError("closed")
            if self.behavior == "value":
                raise ValueError("unknown endpoint")
            if self.behavior == "boom":
                raise RuntimeError("kaboom")
            return Future()  # never resolves: 504

        def stats(self):
            return {"pending": 0}

    stub = _Stub()
    front = HttpFront(stub, port=0, request_timeout=0.05)
    front.start()
    try:
        body = wire.encode_request(np.zeros((1, 2), np.float32))
        for behavior, status, reason in (("queue_full", 503, "queue_full"),
                                         ("closed", 503, "closed"),
                                         ("value", 400, "bad_request"),
                                         ("boom", 500, "internal"), ("ok", 504, "timeout")):
            stub.behavior = behavior
            got, data = _http(front.host, front.port, "POST", "/v1/e", body)
            assert got == status, (behavior, got)
            assert json.loads(data)["reason"] == reason
    finally:
        front.stop()


def test_front_drain_stops_listener_and_closes_connections(rng):
    with _cdist_server() as srv:
        srv.warmup()
        front = HttpFront(srv, port=0)
        front.start()
        conn = http.client.HTTPConnection(front.host, front.port, timeout=5)
        conn.request("POST", "/v1/cdist", body=wire.encode_request(np.zeros((1, 8), np.float32)))
        resp = conn.getresponse()
        resp.read()
        assert resp.status == 200 and resp.getheader("Connection") != "close"
        srv._draining = True  # phase one without the close, to read the header
        conn.request("POST", "/v1/cdist", body=wire.encode_request(np.zeros((1, 8), np.float32)))
        resp = conn.getresponse()
        assert resp.status == 503 and resp.getheader("Connection") == "close"
        assert json.loads(resp.read())["reason"] == "draining"
        conn.close()
        srv._draining = False
        port = front.port
        assert front.drain(5.0) is True
        with pytest.raises(OSError):
            _http(front.host, port, "GET", "/healthz", timeout=0.5)


def test_server_drain_completes_backlog_and_sheds_new_submits(rng):
    srv = _cdist_server(max_wait_ms=5.0)
    srv.warmup()
    futs = [srv.submit("cdist", rng.standard_normal((1, 8)).astype(np.float32))
            for _ in range(6)]
    assert srv.drain(30.0) is True
    for f in futs:
        assert np.asarray(f.result(0)).shape == (1, 32)
    st = srv.stats()
    assert srv.draining and st["closed"] and st["pending"] == 0
    assert srv.drain(1.0) is True
    srv = _cdist_server()
    try:
        srv._draining = True
        with pytest.raises(ServerOverloadedError) as ei:
            srv.submit("cdist", rng.standard_normal((1, 8)).astype(np.float32))
        assert (ei.value.reason, ei.value.status) == ("draining", 503)
        assert srv.stats()["shed"] == 1
    finally:
        srv._draining = False
        srv.close()


def test_routers_of_either_package_reach_replicas_of_the_other(rng):
    q = rng.standard_normal((2, 8)).astype(np.float32)
    ref = _ref()
    port_srv = _cdist_server()
    jax_srv = ht_tpu.serve.Server(max_batch=4, max_wait_ms=1.0)
    jax_srv.register("cdist", ht_tpu.serve.cdist_query(ref))
    port_front, jax_front = HttpFront(port_srv, port=0), JaxHttpFront(jax_srv, port=0)
    port_front.start()
    jax_front.start()
    try:
        want_port = port_srv.predict("cdist", q)
        want_jax = np.asarray(jax_srv.predict("cdist", q))
        with JaxRouter([port_front.url], poll_ms=1000.0, workers=1) as jr:
            assert np.asarray(jr.predict("cdist", q)).tobytes() == want_port.tobytes()
        with Router([jax_front.url], poll_ms=1000.0, workers=1) as pr:
            assert np.asarray(pr.predict("cdist", q)).tobytes() == want_jax.tobytes()
        np.testing.assert_allclose(want_port, want_jax, rtol=1e-5, atol=1e-5)
    finally:
        port_front.stop()
        jax_front.stop()
        port_srv.close()
        jax_srv.close()


# -- the router against scripted fakes -----------------------------------------------------


class _FakeReplica:
    """A scripted replica front: /healthz and /stats always answer; a POST
    runs ``behavior()``, which returns ``(status, body)`` or ``"drop"``
    (close the socket after reading the request)."""

    def __init__(self, behavior, port=0):
        fake = self

        class _H(BaseHTTPRequestHandler):
            # one request a connection: a keep-alive fake would outlive
            # stop() through its handler threads, unlike a dead process
            protocol_version = "HTTP/1.0"

            def log_message(self, fmt, *args):
                pass

            def _reply(self, status, body):
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                self._reply(200, b'{"ok": true}' if self.path == "/healthz" else b'{"pending": 0}')

            def do_POST(self):
                fake.posts += 1
                self.rfile.read(int(self.headers.get("Content-Length", 0)))
                out = fake.behavior()
                if out == "drop":
                    import socket

                    self.connection.shutdown(socket.SHUT_RDWR)
                    self.connection.close()
                    return
                self._reply(*out)

        self.behavior = behavior
        self.posts = 0
        self._cls = _H
        self.port = port
        self._serve()
        self.url = f"http://127.0.0.1:{self.port}"

    def _serve(self):
        self.httpd = ThreadingHTTPServer(("127.0.0.1", self.port), self._cls)
        self.httpd.daemon_threads = True
        self.port = self.httpd.server_address[1]
        self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self._thread.start()

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self._thread.join(5.0)

    restart = _serve  # a new listener on the same port


def _ok_body():
    return 200, wire.encode_response(np.arange(6, dtype=np.float32).reshape(2, 3))


def _shed_body():
    return 503, wire.encode_error("full", "queue_full")


def _router(urls, **kw):
    kw.setdefault("retries", 2)
    kw.setdefault("poll_ms", 1000.0)
    kw.setdefault("workers", 1)
    return Router(urls, **kw)


X = np.zeros((1, 2), np.float32)


def test_router_retries_siblings_after_a_shed():
    shed, good = _FakeReplica(_shed_body), _FakeReplica(_ok_body)
    router = _router([shed.url, good.url])
    try:
        got = router.predict("e", X)
        assert np.asarray(got).tobytes() == np.arange(6, dtype=np.float32).tobytes()
        assert shed.posts == 1 and good.posts == 1
        counts = router.stats()["router"]
        assert (counts["retries"], counts["requests"], counts["shed"]) == (1, 1, 0)
        assert router.stats()["replicas"][shed.url]["up"]
    finally:
        router.close()
        shed.stop()
        good.stop()


def test_router_every_replica_shedding_surfaces_503():
    shed = _FakeReplica(_shed_body)
    router = _router([shed.url], retries=3)
    try:
        with pytest.raises(ServerOverloadedError) as ei:
            router.predict("e", X)
        assert ei.value.reason == "queue_full" and router.stats()["router"]["shed"] == 1
    finally:
        router.close()
        shed.stop()


def test_router_evicts_a_refused_replica():
    good, dead = _FakeReplica(_ok_body), _FakeReplica(_ok_body)
    dead_url = dead.url
    dead.stop()
    router = _router([dead_url, good.url])
    try:
        assert np.asarray(router.predict("e", X)).shape == (2, 3)
        assert router.stats()["router"]["evictions"] == 1
        assert not router.stats()["replicas"][dead_url]["up"]
    finally:
        router.close()
        good.stop()


@pytest.mark.parametrize("retry_in_flight", [False, True])
def test_router_in_flight_drop(retry_in_flight):
    dropper, sibling = _FakeReplica(lambda: "drop"), _FakeReplica(_ok_body)
    router = _router([dropper.url, sibling.url], retry_in_flight=retry_in_flight)
    try:
        if retry_in_flight:
            assert np.asarray(router.predict("e", X)).shape == (2, 3)
            assert sibling.posts == 1
        else:
            with pytest.raises(ReplicaDownError):
                router.predict("e", X)
            assert sibling.posts == 0 and router.stats()["router"]["failed"] == 1
    finally:
        router.close()
        dropper.stop()
        sibling.stop()


def test_router_slow_answer_times_out_without_eviction():
    slow = _FakeReplica(lambda: (time.sleep(1.0), _ok_body())[1])
    router = _router([slow.url], request_timeout=0.3)
    try:
        with pytest.raises(ServeError) as ei:
            router.predict("e", X, timeout=10)
        assert not isinstance(ei.value, ReplicaDownError)
        st = router.stats()
        assert st["replicas"][slow.url]["up"]
        assert (st["router"]["evictions"], st["router"]["failed"]) == (0, 1)
    finally:
        router.close()
        slow.stop()


def test_router_health_poll_evicts_then_readds():
    fake = _FakeReplica(_ok_body)
    router = _router([fake.url], retries=0, poll_ms=20.0)
    try:
        router.predict("e", X)
        fake.stop()
        _wait_until(lambda: not router.stats()["replicas"][fake.url]["up"], what="eviction")
        fake.restart()
        _wait_until(lambda: router.stats()["replicas"][fake.url]["up"], what="re-add")
        assert router.stats()["router"]["readds"] == 1
        assert np.asarray(router.predict("e", X)).shape == (2, 3)
    finally:
        router.close()
        fake.stop()


def test_router_does_not_retry_a_4xx_and_dedupes_targets():
    bad = _FakeReplica(lambda: (400, wire.encode_error("no such endpoint", "bad_request")))
    sibling = _FakeReplica(_ok_body)
    router = _router([bad.url, sibling.url])
    try:
        with pytest.raises(ValueError):
            router.predict("missing", X)
        counts = router.stats()["router"]
        assert sibling.posts == 0 and (counts["failed"], counts["retries"]) == (1, 0)
        router.add_target(bad.url)
        assert len(router.stats()["replicas"]) == 2
    finally:
        router.close()
        bad.stop()
        sibling.stop()
    with pytest.raises(ServerClosedError):
        router.submit("e", X)


def test_fleet_views_raise_naming_the_roadmap_item():
    fake = _FakeReplica(_ok_body)
    router = _router([fake.url])
    try:
        for call in (router.cluster_summary, router.check_slos, router.prometheus_text,
                     lambda: router.export_cluster_trace("x.json")):
            with pytest.raises(NotImplementedError, match="item 13"):
                call()
        assert list(router.scrape_metrics()) == [fake.url]
    finally:
        router.close()
        fake.stop()


@pytest.mark.parametrize("kw", [{"hedge": True}, {"hedge_delay_ms": 5.0},
                                {"priorities": {"latency": 8.0}},
                                {"endpoint_priorities": {"e": "bulk"}},
                                {"priority_queue_max": 4}])
def test_priorities_and_hedging_raise_naming_the_roadmap_item(kw):
    with pytest.raises(NotImplementedError, match="item 14"):
        Router(["127.0.0.1:1"], **kw)
    with pytest.raises(TypeError, match="hedges"):
        Router(["127.0.0.1:1"], hedges=True)


def test_router_priority_calls_raise_and_close_fails_queued_requests():
    slow = _FakeReplica(lambda: (time.sleep(0.5), _ok_body())[1])
    router = _router([slow.url], hedge=False)
    try:
        with pytest.raises(NotImplementedError, match="item 14"):
            router.submit("e", X, priority="latency")
        with pytest.raises(NotImplementedError, match="item 14"):
            router.set_priority("e", "bulk")
        first = router.submit("e", X)
        _wait_until(lambda: slow.posts == 1, what="the first post")
        queued = router.submit("e", X)  # the one worker is busy
        assert "priority" not in router.stats()
    finally:
        router.close()
        slow.stop()
    assert np.asarray(first.result(5.0)).shape == (2, 3)
    with pytest.raises(ServerClosedError):
        queued.result(5.0)
    assert slow.posts == 1


def test_a_closed_idle_connection_is_not_reused():
    import socket

    a, b = socket.socketpair()
    try:
        assert not router_mod._dropped(a)
        b.close()
        assert router_mod._dropped(a)
    finally:
        a.close()


def test_router_over_two_live_fronts(rng):
    q = rng.standard_normal((2, 8)).astype(np.float32)
    with _cdist_server() as direct:
        want = direct.predict("cdist", q)
    servers = [_cdist_server(), _cdist_server()]
    fronts = [HttpFront(s, port=0) for s in servers]
    for s, f in zip(servers, fronts):
        s.warmup()
        f.start()
    router = Router([f.url for f in fronts], poll_ms=50.0, workers=4, max_inflight=1)
    try:
        for fut in [router.submit("cdist", q) for _ in range(16)]:
            assert np.asarray(fut.result(30)).tobytes() == want.tobytes()
        assert all(f.stats_payload()["net"]["http_requests"] > 0 for f in fronts)
        st = router.stats()
        assert st["router"]["requests"] == 16 and st["endpoints"]["cdist"]["requests"] == 16
    finally:
        router.close()
        for f in fronts:
            f.stop()
        for s in servers:
            s.close()


# -- two replica processes, a router and a rolling update ---------------------------------


def test_two_cpu_replicas_roll_onto_a_published_version(rng, tmp_path):
    t_start = time.monotonic()
    ref = _ref()
    q = rng.standard_normal((2, 8)).astype(np.float32)
    v1_path, v2_path = str(tmp_path / "v1"), str(tmp_path / "v2")
    with _cdist_server() as srv:
        srv.warmup()
        want_v1 = srv.predict("cdist", q)
        srv.save(v1_path)
        out = srv.publish("cdist", srv.endpoints()["cdist"].with_params([ref * 2.0]))
        assert (out["version"], out["backend_compiles"]) == (2, 0)
        want_v2 = srv.predict("cdist", q)
        srv.save(v2_path)
    pool = ReplicaPool(v1_path, 2, device="cpu", ready_timeout=60.0,
                       env={"HEAT_TPU_SERVE_MAX_BATCH": "4"}, log_dir=str(tmp_path / "logs"))
    router = None
    try:
        pool.start()
        assert all(h.ready["device"] == "cpu" and h.ready["kernel_builds"] == 0
                   for h in pool.replicas)
        router = Router(pool, retries=2, poll_ms=25.0, workers=4, request_timeout=30.0)
        futs = [router.submit("cdist", q) for _ in range(16)]
        for f in futs:
            assert np.asarray(f.result(30)).tobytes() == want_v1.tobytes()
        for h in pool.replicas:
            net = pool.stats(h.index)["net"]
            assert net["steady_backend_compiles"] == 0 and net["http_requests"] > 0, net
            assert net["warmup"]["backend_compiles"] == net["warmup"]["programs"]

        answers, errors, stop = [], [], threading.Event()

        def traffic():
            while not stop.is_set():
                try:
                    answers.append(np.asarray(router.predict("cdist", q, timeout=30)).tobytes())
                except Exception as e:  # noqa: BLE001 - the test counts them
                    errors.append(repr(e))

        workers = [threading.Thread(target=traffic, daemon=True) for _ in range(2)]
        for w in workers:
            w.start()
        rolled = streaming.rolling_update(pool, router, v2_path, drain_timeout=30.0)
        time.sleep(0.2)
        stop.set()
        for w in workers:
            w.join(30.0)
        assert not any(w.is_alive() for w in workers)
        assert errors == [], errors[:3]
        assert answers and set(answers) <= {want_v1.tobytes(), want_v2.tobytes()}
        assert answers[-1] == want_v2.tobytes()
        assert [s["drain_rc"] for s in rolled["steps"]] == [0, 0]
        assert rolled["versions"] and all(v == {"cdist": 2} for v in rolled["versions"].values())
        for idx in (0, 1):
            exits = [o for o in pool.handle(idx).exit_lines() if o.get("exit")]
            assert exits and exits[0]["drained"] is True
        assert np.asarray(router.predict("cdist", q, timeout=30)).tobytes() == want_v2.tobytes()
    finally:
        if router is not None:
            router.close()
        pool.close()
    assert time.monotonic() - t_start < 90.0


_FRESH = textwrap.dedent("""
    import sys
    import numpy as np
    import heat_tpu_torch as ht
    from heat_tpu_torch import serve
    from heat_tpu_torch.serve.net import HttpFront, Router, replica
    ht.use_device("cpu")
    srv = serve.Server(max_batch=4)
    srv.register("c", serve.cdist_query(np.eye(4, dtype=np.float32)))
    srv.warmup()
    with HttpFront(srv, port=0) as front, Router([front.url], workers=1) as router:
        router.predict("c", np.ones((2, 4), np.float32))
    srv.close()
    bad = sorted(n for n in sys.modules if n.split(".")[0] in ("heat_tpu", "jax", "jaxlib"))
    print("MODULES", bad)
""")


def test_the_serving_path_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    out = subprocess.run([sys.executable, "-c", _FRESH], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "MODULES []" in out.stdout, out.stdout
