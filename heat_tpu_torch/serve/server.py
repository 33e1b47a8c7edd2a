"""The micro-batched inference server.

Counterpart of ``heat_tpu/serve/server.py``. A request's life::

    submit(name, payload)
      └─ admission gate (queue depth, memory budget: 503-style shed, or
         ladder degradation)                           [caller thread]
      └─ FIFO queue
    batcher thread
      └─ coalesce consecutive same-endpoint requests up to the ladder cap
         within a short gather window
      └─ pad the rows up to the smallest ladder bucket (zero rows; every
         form is row-independent, and in exact mode a request's answer is
         the same bits as its solo dispatch)
      └─ ONE dispatch through program_cache.cached_program (site
         ``serve.<name>``): on the card the bucket's CUDA graph replayed,
         the padded batch copied host-to-device once inside it and the
         result copied back once; wrapped by resilience.wrap_program, so
         the fault injector, the memory preflight and the retry guard run
         per *batch*
      └─ slice the results back per request, resolve the futures, record
         latency and occupancy

``warmup()`` builds every endpoint's whole ladder (one program per
(endpoint, bucket), captured on the card with TF32 off), so the steady
state builds **nothing**: every dispatch is a registry hit and a graph
replay. The programs of one endpoint's buckets share one set of static
parameter buffers on the card.

Knobs (each overridable by a constructor argument):
``HEAT_TPU_SERVE_MAX_BATCH`` (ladder top, 64), ``HEAT_TPU_SERVE_LADDER``
(explicit buckets), ``HEAT_TPU_SERVE_MAX_WAIT_MS`` (gather window, 2),
``HEAT_TPU_SERVE_QUEUE_MAX`` (admission bound, 1024),
``HEAT_TPU_SERVE_EXACT`` (the batch-stable forms, on).

``save(path)`` writes every endpoint's parameters and static config
through :mod:`heat_tpu_torch.resilience.checkpoint` in the JAX package's
format; ``Server.restore(path)`` rebuilds the endpoints without refitting,
from a checkpoint of either package.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import _knobs as knobs
from .. import telemetry
from ..core import program_cache
from ..resilience import memory_guard
from .admission import (
    AdmissionController,
    ServerClosedError,
    ServerOverloadedError,
)
from . import tracing
from .endpoints import Endpoint, rebuild
from .metrics import EndpointStats

__all__ = ["Server"]

DEFAULT_MAX_BATCH = 64
DEFAULT_WAIT_MS = 2.0

_SHUTDOWN = object()
# submit()'s trace default: mint locally at this ingress. Distinct from
# None, which transports pass to say "the remote ingress decides": a
# router that sent no trace field must not have the replica re-mint.
_MINT = object()


def _resolve(fut: Future, value=None, exc=None) -> None:
    """Resolve a future exactly once. A close() racing a live batcher can
    reach the same request from both sides (drain vs in-flight batch);
    the second resolution must be a no-op, not an InvalidStateError that
    kills the batcher thread mid-batch."""
    try:
        if exc is not None:
            fut.set_exception(exc)
        else:
            fut.set_result(value)
    except Exception:  # concurrent.futures.InvalidStateError
        pass


def _host(a: np.ndarray) -> np.ndarray:
    """A C-contiguous, writable array ``torch.from_numpy`` can wrap."""
    return np.require(a, requirements=("C", "W"))


def _default_ladder(max_batch: int) -> List[int]:
    ladder = []
    b = 1
    while b < max_batch:
        ladder.append(b)
        b *= 2
    ladder.append(max_batch)
    return ladder


def _env_ladder(max_batch: int) -> List[int]:
    raw = (knobs.raw("HEAT_TPU_SERVE_LADDER", "") or "").strip()
    if raw:
        try:
            vals = sorted({int(v) for v in raw.split(",") if v.strip()})
            if vals and all(v > 0 for v in vals):
                return vals
        except ValueError:
            pass
    return _default_ladder(max_batch)


class _Request:
    __slots__ = (
        "endpoint", "array", "rows", "squeeze", "future", "t_submit",
        "t_wall", "ctx",
    )

    def __init__(self, endpoint: str, array, squeeze: bool, ctx=None):
        # `array` is a dense (rows, features) ndarray, or a CsrRows
        # batch for sparse endpoints (both expose .shape[0])
        self.endpoint = endpoint
        self.array = array
        self.rows = int(array.shape[0])
        self.squeeze = squeeze
        self.future: Future = Future()
        self.t_submit = time.perf_counter()
        # wall-clock twin of t_submit: trace spans anchor on wall time
        # so cross-process merges have one clock domain to reconcile
        self.t_wall = time.time() if ctx is not None else 0.0
        self.ctx = ctx  # Optional[tracing.TraceContext]


class Server:
    """Multi-tenant micro-batched inference front end over fitted
    estimators (the module docstring has the architecture)."""

    def __init__(
        self,
        *,
        max_batch: Optional[int] = None,
        ladder: Optional[Sequence[int]] = None,
        max_wait_ms: Optional[float] = None,
        queue_max: Optional[int] = None,
    ):
        if knobs.get("HEAT_TPU_AUTOTUNE"):
            # tuned serve knobs land in the overlay before the reads below,
            # so a fresh process builds its server tuned; explicit
            # arguments still win over any tuned value
            from .. import autotune

            autotune.warm_start()
        if max_batch is None:
            max_batch = max(1, int(knobs.get("HEAT_TPU_SERVE_MAX_BATCH")))
        self.max_batch = int(max_batch)
        if ladder is not None:
            ladder = sorted({int(b) for b in ladder})
            if not ladder or ladder[0] < 1:
                raise ValueError(f"invalid bucket ladder {ladder!r}")
        else:
            ladder = _env_ladder(self.max_batch)
        self.ladder = list(ladder)
        if max_wait_ms is None:
            max_wait_ms = knobs.get("HEAT_TPU_SERVE_MAX_WAIT_MS")
            max_wait_ms = max_wait_ms if max_wait_ms >= 0 else DEFAULT_WAIT_MS
        self.max_wait = max_wait_ms / 1e3
        self._endpoints: Dict[str, Endpoint] = {}
        self._stats: Dict[str, EndpointStats] = {}
        self._measured: Dict[tuple, int] = {}  # (name, bucket) -> bytes
        self.admission = AdmissionController(
            queue_max,
            measured_cost=lambda name, bucket: self._measured.get(
                (name, bucket)
            ),
        )
        self._queue: "queue.Queue" = queue.Queue()
        self._carry: Optional[_Request] = None
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._closed = False
        self._draining = False
        # admitted-but-unresolved request count (NOT queue depth: a
        # request leaves the queue before its batch resolves). drain()
        # waits on this reaching zero, so in-flight batches finish.
        self._pending = 0
        self._pending_lock = threading.Lock()

    # -- registration --------------------------------------------------------

    def register(
        self, name: str, endpoint: Endpoint, *, replace: bool = False
    ) -> "Server":
        """Mount ``endpoint`` under ``name`` (the dispatch site becomes
        ``serve.<name>``). Re-registering a live name is an explicit
        *versioned publish*: it requires ``replace=True``,
        assigns the newcomer ``max(old, new) + 1`` when its version does
        not already supersede the old one, and swaps the endpoint in
        with one atomic dict assignment — the dispatch loop reads the
        endpoint exactly once per micro-batch, so a batch is served
        entirely by one version (bit-exact cutover between batches).
        Without ``replace=True`` a duplicate name raises instead of
        silently shadowing the fitted estimator. A same-shape publish
        keeps the warmed-cost memo and re-enters the warm programs (their
        graphs copy the new parameters in once); a shape change drops the
        memo (the old programs stay in the registry for any future
        endpoint with the same shapes)."""
        if not isinstance(endpoint, Endpoint):
            raise TypeError(
                f"endpoint must be a serve.Endpoint, got {type(endpoint)}"
            )
        if not name or "/" in name or ":" in name:
            raise ValueError(f"invalid endpoint name {name!r}")
        with self._lock:
            if self._closed:
                raise ServerClosedError("server is closed")
            old = self._endpoints.get(name)
            if old is not None:
                if not replace:
                    raise ValueError(
                        f"endpoint {name!r} is already registered "
                        f"(version {old.version}); re-registering a live "
                        f"name is a versioned publish — pass replace=True"
                    )
                if endpoint.version <= old.version:
                    endpoint.version = old.version + 1
                same_sig = (
                    old.program_key(0) == endpoint.program_key(0)
                )
                self._endpoints[name] = endpoint
                if not same_sig:
                    for key in [k for k in self._measured if k[0] == name]:
                        del self._measured[key]
                return self
            self._endpoints[name] = endpoint
            self._stats[name] = EndpointStats(name)
            for key in [k for k in self._measured if k[0] == name]:
                del self._measured[key]
        return self

    def endpoints(self) -> Dict[str, Endpoint]:
        return dict(self._endpoints)

    def endpoint_version(self, name: str) -> int:
        """The currently-mounted version of ``name`` (KeyError when the
        endpoint is unknown) — the transport stamps this into every
        response envelope so clients can observe rolling updates."""
        return self._endpoints[name].version

    def publish(self, name: str, endpoint: Endpoint, *, warm: bool = True) -> dict:
        """Versioned publish with build accounting: swap ``endpoint`` in
        under ``name`` (``register(replace=True)``), re-warm it under a
        :class:`telemetry.CompileWatcher`, and emit a ``version_swap``
        streaming event with the swap's seconds and builds (0 for a
        same-shape publish: no graph is captured). Returns ``{"name",
        "version", "seconds", "backend_compiles"}``."""
        t0 = time.perf_counter()
        self.register(name, endpoint, replace=True)
        compiles = 0
        if warm:
            report = self.warmup([name])
            compiles = int(report.get("backend_compiles", 0))
        version = self._endpoints[name].version
        out = {
            "name": name,
            "version": version,
            "seconds": round(time.perf_counter() - t0, 6),
            "backend_compiles": compiles,
        }
        from ..streaming import events as _stream_events

        _stream_events.emit(
            name, "version_swap",
            version=version, seconds=out["seconds"],
            backend_compiles=compiles,
        )
        return out

    # -- warm-up -------------------------------------------------------------

    def warmup(self, names: Optional[Sequence[str]] = None) -> dict:
        """Build (on the card: capture a CUDA graph of) every registered
        endpoint's whole batch-size ladder by one call on zeros each, so
        that serving replays warm programs only. With a memory budget set,
        also records each bucket's measured bytes for the admission
        controller. Returns ``{"endpoints", "programs",
        "backend_compiles", "seconds"}``; ``backend_compiles`` counts the
        builds in the window (0 on a re-warm)."""
        t0 = time.perf_counter()
        targets = list(names) if names is not None else list(self._endpoints)
        programs = 0
        budget_armed = memory_guard.budget_bytes() is not None
        with telemetry.CompileWatcher() as cw:
            for name in targets:
                ep = self._endpoints[name]  # KeyError = caller bug, loud
                for bucket in self.ladder:
                    if ep.is_sparse:
                        # sparse endpoints warm the whole (row bucket,
                        # nnz bucket) lattice — ragged steady-state
                        # traffic then lands only on warm programs
                        for nnz_cap in ep.nnz_ladder(bucket):
                            prog = self._program(name, ep, bucket, nnz_cap)
                            args = (
                                torch.zeros((bucket + 1,), dtype=torch.int32),
                                torch.zeros((nnz_cap,), dtype=torch.int32),
                                torch.from_numpy(np.zeros((nnz_cap,), dtype=ep.dtype)),
                            ) + tuple(ep.params)
                            prog(*args).cpu()
                            programs += 1
                            if budget_armed:
                                self._measured[(name, bucket)] = max(
                                    self._measured.get((name, bucket), 0),
                                    memory_guard.program_bytes(prog, args),
                                )
                        continue
                    prog = self._program(name, ep, bucket)
                    zeros = torch.from_numpy(np.zeros((bucket, ep.features), dtype=ep.dtype))
                    prog(zeros, *ep.params).cpu()  # warm-up owns the build's wait
                    programs += 1
                    if budget_armed:
                        self._measured[(name, bucket)] = (
                            memory_guard.program_bytes(
                                prog, (zeros,) + tuple(ep.params)
                            )
                        )
        dt = time.perf_counter() - t0
        report = {
            "endpoints": len(targets),
            "programs": programs,
            "backend_compiles": cw.backend_compiles,
            "seconds": round(dt, 4),
        }
        if telemetry.enabled():
            telemetry.get_registry().emit(
                "serve", "warmup", event="warmup", **report
            )
        return report

    # -- request path --------------------------------------------------------

    def submit(self, name: str, payload, trace=_MINT) -> Future:
        """Admit + enqueue one request; returns a
        :class:`concurrent.futures.Future` resolving to the result rows
        (1-D payloads resolve to a single row). Sheds with
        :class:`ServerOverloadedError` (status 503) at the admission
        gate; a failed dispatch (after per-batch retries) resolves the
        future with the error.

        ``trace`` selects the request's trace context: the
        default mints one here (in-process serving makes ``submit`` the
        ingress), an adopted :class:`~.tracing.TraceContext`
        or wire dict continues an upstream router's trace, and ``None``
        means untraced (the transport's verdict for requests whose
        ingress sent no trace field). Tracing never changes the result —
        answers are bit-identical on and off."""
        with self._lock:
            if self._closed:
                raise ServerClosedError("server is closed")
            ep = self._endpoints.get(name)
        if ep is None:
            raise ValueError(
                f"unknown endpoint {name!r}; registered: "
                f"{sorted(self._endpoints)}"
            )
        if ep.is_sparse:
            from ..sparse.host import CsrRows

            squeeze = False
            if not isinstance(payload, CsrRows):
                # a dense row (or batch) is a legal sparse request too —
                # compact it so callers need not hand-build CSR
                dense = np.asarray(payload, dtype=ep.dtype)
                squeeze = dense.ndim == 1
                payload = CsrRows.from_dense(dense)
            if payload.cols != ep.features:
                raise ValueError(
                    f"endpoint {name!r} expects CSR rows over "
                    f"{ep.features} features, got {payload.cols}"
                )
            arr = CsrRows(
                payload.indptr, payload.indices,
                payload.values.astype(ep.dtype, copy=False), ep.features,
            )
        else:
            arr = np.asarray(payload, dtype=ep.dtype)
            squeeze = arr.ndim == 1
            if squeeze:
                arr = arr[None, :]
            if arr.ndim != 2 or arr.shape[1] != ep.features:
                raise ValueError(
                    f"endpoint {name!r} expects (rows, {ep.features}) "
                    f"payloads, got shape {np.asarray(payload).shape}"
                )
        st = self._stats[name]
        try:
            if self._draining:
                # drain-then-kill: a draining replica sheds
                # every NEW request 503-style so the router retries a
                # sibling, while queued + in-flight work still completes
                self.admission.shed(
                    name, "draining",
                    "server is draining (shutting down gracefully); "
                    "retry another replica",
                )
            self.admission.admit(
                name, ep, arr.shape[0], self._queue.qsize(), self.ladder
            )
        except ServerOverloadedError:
            st.record_shed()
            raise
        if trace is _MINT:
            ctx = tracing.mint("serve.submit")
        elif isinstance(trace, tracing.TraceContext):
            ctx = trace
        elif trace is not None:
            ctx = tracing.from_wire(trace)
        else:
            ctx = None
        req = _Request(name, arr, squeeze, ctx)
        with self._pending_lock:
            self._pending += 1
        st.record_request(req.rows)
        if telemetry.enabled():
            reg = telemetry.get_registry()
            reg.add("serve.requests", 1)
            reg.high_water("serve.queue_depth", self._queue.qsize() + 1)
        self._ensure_thread()
        self._queue.put(req)
        if self._closed:
            # close() may have drained the queue between our admission
            # check and the put — never strand a future
            self._drain_pending()
        return req.future

    def predict(self, name: str, payload, timeout: Optional[float] = 30.0):
        """Synchronous convenience: ``submit(...).result(timeout)``."""
        return self.submit(name, payload).result(timeout)

    # -- lifecycle -----------------------------------------------------------

    def drain(self, timeout: float = 30.0) -> bool:
        """Graceful shutdown, phase one: stop admitting —
        every new :meth:`submit` sheds with ``reason="draining"``
        (status 503, so a router retries siblings) — then wait for every
        already-admitted request (queued *and* in-flight batches) to
        resolve, and :meth:`close`. Returns ``True`` when the backlog
        fully resolved inside ``timeout`` (a ``False`` close still
        failed the leftovers with :class:`ServerClosedError`, nothing
        hangs). Idempotent; the replica SIGTERM handler runs exactly
        ``drain() -> telemetry.flush() -> exit 0``."""
        with self._lock:
            if self._closed:
                return True
            self._draining = True
        if telemetry.enabled():
            telemetry.get_registry().emit(
                "serve", "server", event="drain",
                pending=self._pending, queue_depth=self._queue.qsize(),
            )
        deadline = time.monotonic() + max(0.0, timeout)
        drained = False
        while True:
            with self._pending_lock:
                if self._pending == 0:
                    drained = True
            if drained or time.monotonic() >= deadline:
                break
            time.sleep(0.002)
        self.close()
        return drained

    @property
    def draining(self) -> bool:
        """Whether :meth:`drain` has begun (new submits shed 503)."""
        return self._draining

    def close(self, timeout: float = 10.0) -> None:
        """Stop accepting requests, drain the batcher, fail whatever is
        still pending with :class:`ServerClosedError`. Idempotent."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            thread = self._thread
        self._queue.put(_SHUTDOWN)
        if thread is not None:
            thread.join(timeout)
        self._drain_pending()

    def _drain_pending(self) -> None:
        """Fail every still-queued request with ServerClosedError (only
        called once the batcher is no longer consuming)."""
        leftovers = []
        if self._carry is not None:
            leftovers.append(self._carry)
            self._carry = None
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is not _SHUTDOWN:
                leftovers.append(item)
        for req in leftovers:
            _resolve(
                req.future,
                exc=ServerClosedError("server closed with request pending"),
            )
        if leftovers:
            with self._pending_lock:
                self._pending -= len(leftovers)

    def __enter__(self) -> "Server":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    # -- checkpoint/restore --------------------------------------------------

    def save(self, path: str) -> str:
        """Checkpoint every endpoint's fitted parameters + static config
        (CRC-verified blobs, atomic directory swap —
        :mod:`heat_tpu_torch.resilience.checkpoint`). The server keeps
        serving; restore with :meth:`Server.restore`."""
        from .. import resilience

        leaves: List[np.ndarray] = []
        records = []
        with self._lock:
            for name in sorted(self._endpoints):
                ep = self._endpoints[name]
                rec = ep.describe()
                rec["name"] = name
                records.append(rec)
                leaves.extend(p.detach().cpu().numpy() for p in ep.params)
        return resilience.save_checkpoint(
            leaves, path,
            extra={"serve": {"version": 1, "endpoints": records},
                   "algo": "serve"},
        )

    @classmethod
    def restore(cls, path: str, *, device=None, **server_kwargs) -> "Server":
        """Rebuild a server (endpoints + fitted parameters, on ``device``:
        the card unless the CPU is asked for) from a :meth:`save`
        checkpoint of either package, without a refit. Call :meth:`warmup`
        after; the same parameter shapes re-enter the registry's programs,
        so a restore-then-warm in a live process builds nothing."""
        from .. import resilience

        leaves, extra = resilience.load_checkpoint(path, with_extra=True)
        meta = (extra or {}).get("serve")
        if not meta or "endpoints" not in meta:
            raise resilience.CheckpointError(
                f"{path!r} is not a serve checkpoint (algo="
                f"{(extra or {}).get('algo')!r})"
            )
        server = cls(**server_kwargs)
        off = 0
        for rec in meta["endpoints"]:
            n = int(rec["n_params"])
            server.register(rec["name"], rebuild(rec, leaves[off:off + n], device=device))
            off += n
        if off != len(leaves):
            raise resilience.CheckpointError(
                f"serve checkpoint {path!r} holds {len(leaves)} parameter "
                f"blobs but the manifest accounts for {off}"
            )
        return server

    # -- introspection -------------------------------------------------------

    def stats(self) -> dict:
        """Live serving stats: per-endpoint request/batch/latency
        aggregates, queue depth, ladder state, shed/degrade counts, and
        the ``serve.*`` program-registry counters (the zero-recompile
        oracle)."""
        return {
            "endpoints": {
                name: s.snapshot() for name, s in self._stats.items()
            },
            "versions": {
                name: ep.version for name, ep in self._endpoints.items()
            },
            "queue_depth": self._queue.qsize(),
            "ladder": list(self.ladder),
            "bucket_cap": self.admission.bucket_cap(self.ladder),
            "shed": self.admission.sheds,
            "degrades": self.admission.degrades,
            "programs": program_cache.site_stats("serve."),
            "pending": self._pending,
            "draining": self._draining,
            "closed": self._closed,
        }

    def metrics(self) -> dict:
        """The mergeable form of :meth:`stats` (served on
        ``GET /metrics``): per-endpoint cumulative tallies with RAW
        latency-histogram bucket counts (bucket-wise addition across
        replicas is exact — :meth:`LatencyHistogram.merge`), endpoint
        versions (fleet version-lag detection), the ``serve.*``
        program-registry counters, and the process's telemetry counters
        (includes the ``tracing.*`` pair the CI off-run asserts zero)."""
        snap = telemetry.get_registry().snapshot()
        return {
            "endpoints": {
                name: s.raw_snapshot() for name, s in self._stats.items()
            },
            "versions": {
                name: ep.version for name, ep in self._endpoints.items()
            },
            "queue_depth": self._queue.qsize(),
            "shed": self.admission.sheds,
            "programs": program_cache.site_stats("serve."),
            "counters": snap["counters"],
        }

    # -- internals -----------------------------------------------------------

    def _ensure_thread(self) -> None:
        with self._lock:
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._loop, name="heat_tpu_torch.serve.batcher",
                    daemon=True,
                )
                self._thread.start()

    def _bucket_for(self, rows: int) -> int:
        for b in self.ladder:
            if b >= rows:
                return b
        return self.ladder[-1]

    def _program(
        self, name: str, ep: Endpoint, bucket: int,
        nnz_cap: Optional[int] = None,
    ):
        return program_cache.cached_program(
            f"serve.{name}", ep.program_key(bucket, nnz_cap), ep.build,
            cost_bytes=ep.cost_bytes(bucket), params_from=ep.n_inputs,
            params_key=ep.params_key(), tf32=False,
        )

    def _loop(self) -> None:
        while True:
            if self._carry is not None:
                item, self._carry = self._carry, None
            else:
                try:
                    item = self._queue.get(timeout=0.1)
                except queue.Empty:
                    if self._closed:
                        return
                    continue
            if item is _SHUTDOWN:
                return
            batch = [item]
            rows = item.rows
            cap = self.admission.bucket_cap(self.ladder)
            deadline = time.perf_counter() + self.max_wait
            while rows < cap:
                try:
                    nxt = self._queue.get_nowait()
                except queue.Empty:
                    rem = deadline - time.perf_counter()
                    if rem <= 0:
                        break
                    try:
                        nxt = self._queue.get(timeout=rem)
                    except queue.Empty:
                        break
                if nxt is _SHUTDOWN:
                    self._run_batch(batch)
                    return
                if nxt.endpoint != item.endpoint:
                    # FIFO segments: a different endpoint closes this
                    # micro-batch and opens the next — no reordering
                    self._carry = nxt
                    break
                batch.append(nxt)
                rows += nxt.rows
            self._run_batch(batch)

    def _run_batch(self, reqs: List[_Request]) -> None:
        try:
            self._dispatch_batch(reqs)
        finally:
            # every request in this batch is resolved by now (result,
            # error, or the idempotent no-op if close() raced us) — it
            # stops counting against drain()
            with self._pending_lock:
                self._pending -= len(reqs)

    def _dispatch_batch(self, reqs: List[_Request]) -> None:
        name = reqs[0].endpoint
        ep = self._endpoints[name]
        st = self._stats[name]
        rows = sum(r.rows for r in reqs)
        # request-trace hops: ctxs is empty for every untraced batch
        # (tracing off, telemetry off, or nothing sampled), and every
        # per-hop clock read stays behind that check
        ctxs = [r.ctx for r in reqs if r.ctx is not None]
        t_start = time.perf_counter()
        wall0 = time.time() if ctxs else 0.0
        if ctxs:
            # serve.queue: replica ingress -> the batcher picked this
            # request up (one span per traced request; the coalesce
            # window is accounted to the batch, not the stragglers)
            for r in reqs:
                if r.ctx is not None:
                    # ingress marks the hop whose process MINTED the
                    # context (counter-pairing: one ingress span per
                    # tracing.sampled increment, so an offline sink
                    # replay reconstructs the sampled tally). Contexts
                    # adopted off the wire were counted at the router.
                    tracing.hop(
                        "serve.queue", (r.ctx,), r.t_wall,
                        max(0.0, wall0 - r.t_wall), endpoint=name,
                        ingress=r.ctx.parent_span == "serve.submit",
                    )
        if ep.is_sparse:
            from ..sparse.host import CsrRows

            x = (
                reqs[0].array if len(reqs) == 1
                else CsrRows.concat([r.array for r in reqs])
            )
        else:
            x = (
                reqs[0].array if len(reqs) == 1
                else np.concatenate([r.array for r in reqs], axis=0)
            )
        if ctxs:
            tracing.hop(
                "serve.coalesce", ctxs, wall0,
                time.perf_counter() - t_start, endpoint=name,
                requests=len(reqs), rows=rows,
            )
        cap = self.admission.bucket_cap(self.ladder)
        t0 = time.perf_counter()
        pad_s = 0.0
        exec_s = 0.0
        try:
            pieces = []
            padded_total = 0
            # rows == 0 (a valid empty query) still dispatches one
            # all-pad bucket so the result carries the endpoint's real
            # output shape/dtype with zero rows
            starts = range(0, rows, cap) if rows else (0,)
            for start in starts:
                chunk = x[start:start + cap]
                crows = chunk.shape[0]
                bucket = self._bucket_for(crows)
                pad = bucket - crows
                padded_total += pad
                if ep.is_sparse:
                    tp = time.perf_counter() if ctxs else 0.0
                    nnz_cap = ep.nnz_cap_for(bucket, chunk.nnz)
                    padded = chunk.padded(bucket, nnz_cap)
                    prog = self._program(name, ep, bucket, nnz_cap)
                    if ctxs:
                        te = time.perf_counter()
                        pad_s += te - tp
                    out = prog(
                        torch.from_numpy(padded.indptr.astype(np.int32)),
                        torch.from_numpy(_host(padded.indices)),
                        torch.from_numpy(_host(padded.values)),
                        *ep.params,
                    )
                    pieces.append(out.cpu().numpy()[:crows])
                    if ctxs:
                        exec_s += time.perf_counter() - te
                    continue
                tp = time.perf_counter() if ctxs else 0.0
                if pad:
                    chunk = np.concatenate(
                        [chunk, np.zeros((pad, ep.features), dtype=ep.dtype)],
                        axis=0,
                    )
                prog = self._program(name, ep, bucket)
                if ctxs:
                    te = time.perf_counter()
                    pad_s += te - tp
                # the one host-to-device copy is the program's copy of
                # this host tensor into its graph; the one copy back, .cpu()
                out = prog(torch.from_numpy(_host(chunk)), *ep.params)
                pieces.append(out.cpu().numpy()[:crows])
                if ctxs:
                    exec_s += time.perf_counter() - te
            result = pieces[0] if len(pieces) == 1 else np.concatenate(
                pieces, axis=0
            )
        except Exception as e:  # noqa: BLE001 — per-batch failure isolation
            # the guard already retried transients per batch; whatever
            # reaches here is terminal for THESE requests only — the
            # batcher thread (and every other queued request) lives on
            st.record_error(len(reqs))
            if telemetry.enabled():
                reg = telemetry.get_registry()
                reg.add("serve.failed_requests", len(reqs))
                reg.emit(
                    "serve", name, event="batch_failed",
                    requests=len(reqs), rows=rows, error=repr(e),
                )
            for r in reqs:
                _resolve(r.future, exc=e)
            return
        dt = time.perf_counter() - t0
        st.record_batch(rows, padded_total)
        now = time.perf_counter()
        if ctxs:
            # pad/execute interleave per chunk, so each gets ONE span
            # with its accumulated seconds, anchored where the dispatch
            # loop began (wall = wall0 + perf-clock delta: both stamps
            # were taken at the same instant, so the offset is exact)
            wall_t0 = wall0 + (t0 - t_start)
            tracing.hop(
                "serve.pad", ctxs, wall_t0, pad_s,
                endpoint=name, padded_rows=padded_total,
            )
            tracing.hop(
                "serve.execute", ctxs, wall_t0 + pad_s, exec_s,
                endpoint=name, rows=rows,
            )
        tel = telemetry.enabled()
        reg = telemetry.get_registry() if tel else None
        if tel:
            reg.add("serve.batches", 1)
            reg.add("serve.batch_rows", rows)
            reg.add("serve.padded_rows", padded_total)
            reg.emit(
                "serve_batch", name, rows=rows, requests=len(reqs),
                padded_rows=padded_total, seconds=dt,
                queue_depth=self._queue.qsize(),
                occupancy=rows / max(rows + padded_total, 1),
            )
        off = 0
        for r in reqs:
            piece = result[off:off + r.rows]
            off += r.rows
            latency = now - r.t_submit
            st.record_done(latency)
            if tel:
                reg.emit(
                    "serve_request", name, seconds=latency, rows=r.rows,
                    ok=True,
                )
            _resolve(r.future, piece[0] if r.squeeze else piece)
        if ctxs:
            tracing.hop(
                "serve.reply", ctxs, wall0 + (now - t_start),
                time.perf_counter() - now, endpoint=name,
                requests=len(reqs),
            )
