"""Runtime observability: counters, high-water marks and an event stream.

Counterpart of ``heat_tpu/telemetry/__init__.py`` (:89-447 there): a
process-global :class:`Telemetry` registry with an optional JSON-lines
sink, turned on by :func:`enable` or ``HEAT_TPU_TELEMETRY=1`` (the sink by
``HEAT_TPU_TELEMETRY_SINK``), and :func:`span` for timed regions. A span
waits for the card before it stops its clock when it was given a CUDA
tensor through :meth:`Span.output`, as the JAX package's span blocks on
its outputs, so it times device work and not the enqueue.

Disabled (the default), every hook is one module-flag check: ``span()``
returns a shared no-op object and :func:`op_cost` computes no cost, so
the call sites build no fields.

The submodules are the JAX package's (:87-447 there):

* :mod:`.collectives`, the analytic cost model (bytes on the wire of a
  relayout, a ring, TSQR, a sparse product, ...), function for function;
* :mod:`.hlo`, the collective audit. The JAX package parses the collectives
  XLA emitted; the port issues every collective itself, so the audit
  records the collectives :class:`~heat_tpu_torch.core.communication.
  TorchCommunication` issued while the audited call ran and compares their
  wire bytes with the cost model (``audit=True`` at the instrumented sites,
  or ``HEAT_TPU_HLO_AUDIT=1``);
* :mod:`.memory` (live bytes of the DNDarrays, the caching allocator's
  statistics on the card), :mod:`.report` (the per-phase summary),
  :mod:`.trace` (a Chrome/Perfetto trace, :func:`export_trace`) and
  :mod:`.cluster` (the fleet view of a router and its replicas);
* ``python -m heat_tpu_torch.telemetry.audit "<expr>"`` (:mod:`.audit`).

**Collectives.** Every collective that ``TorchCommunication`` issues
calls :func:`trace_event` once, with its op, the bytes in and out on this
rank and the group size: an always-on count a name
(:func:`collective_counts`), an observation for any open audit, and, while
telemetry records, a ``traced.<name>`` counter and one
``collective_trace`` event. The JAX package fires this event when a
program is traced, so a cached program records nothing; the port issues
its collectives eagerly and records every call. The port's counterpart of
a trace is the capture of a CUDA graph (:mod:`heat_tpu_torch.core.
program_cache`): a collective inside a captured program fires its event
once, at the capture; a replay issues no Python call and fires nothing.

:class:`CompileWatcher` and :func:`measure_compile` (:476-546 there)
count and time the builds of the port's program registry
(:mod:`heat_tpu_torch.core.program_cache`) under the JAX package's field
names: a build is the capture of a CUDA graph on the card and the first
call of an input signature on the CPU, each reported by the registry
through :func:`record_build` as one ``backend_compile_duration`` event.
There is no JAX monitoring listener to install.

"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import defaultdict
from typing import IO, Any, Dict, Iterable, List, Optional, Union

from .. import _knobs as knobs
from . import collectives

__all__ = [
    "CompileWatcher",
    "SLO",
    "Span",
    "Telemetry",
    "cluster",
    "collective_counts",
    "collectives",
    "disable",
    "enable",
    "enabled",
    "export_trace",
    "flush",
    "get_registry",
    "hlo",
    "measure_compile",
    "memory",
    "op_cost",
    "record_build",
    "report",
    "reset_collective_counts",
    "span",
    "summarize_cluster",
    "trace",
    "trace_event",
]

# the one flag every instrumentation site checks
_ENABLED = False
_REGISTRY: Optional["Telemetry"] = None
_REGISTRY_LOCK = threading.Lock()
_STATE = threading.local()  # span nesting, per thread


def _stack() -> list:
    s = getattr(_STATE, "stack", None)
    if s is None:
        s = _STATE.stack = []
    return s


class Telemetry:
    """Counters, high-water marks and an event list, with an optional JSONL
    sink. Events are dicts with at least ``ts`` (unix seconds), ``kind``
    and ``name``; the list and the sink receive the same records."""

    def __init__(self):
        self._lock = threading.Lock()
        self.counters: Dict[str, float] = defaultdict(float)
        self.watermarks: Dict[str, float] = {}
        self.events: List[dict] = []
        self._sink: Optional[IO[str]] = None
        self._sink_path: Optional[str] = None
        self._owns_sink = False

    def attach_sink(self, sink: Union[str, IO[str]]) -> None:
        """A path (opened for appending, owned and closed here) or any
        writable text file."""
        self.close_sink()
        if isinstance(sink, (str, os.PathLike)):
            self._sink = open(sink, "a")
            self._sink_path = os.fspath(sink)
            self._owns_sink = True
        else:
            self._sink = sink
            self._sink_path = getattr(sink, "name", None)
            self._owns_sink = False

    def close_sink(self) -> None:
        if self._sink is not None and self._owns_sink:
            try:
                self._sink.close()
            except OSError:
                pass
        self._sink, self._sink_path, self._owns_sink = None, None, False

    @property
    def sink_path(self) -> Optional[str]:
        return self._sink_path

    def emit(self, kind: str, name: str, **fields: Any) -> dict:
        """Record one event, and write it to the sink if one is attached.
        A sink that fails is detached: telemetry never stops the work."""
        ev = {"ts": time.time(), "kind": kind, "name": name}
        ev.update(fields)
        with self._lock:
            self.events.append(ev)
            if self._sink is not None:
                try:
                    self._sink.write(json.dumps(ev, default=str) + "\n")
                    self._sink.flush()
                except (OSError, ValueError):
                    self.close_sink()
        return ev

    def add(self, counter: str, delta: float = 1.0) -> None:
        with self._lock:
            self.counters[counter] += delta

    def high_water(self, key: str, value: float) -> None:
        """Keep ``value`` if it exceeds the stored mark of ``key``."""
        with self._lock:
            if value > self.watermarks.get(key, float("-inf")):
                self.watermarks[key] = value

    def snapshot(self) -> dict:
        with self._lock:
            return {"counters": dict(self.counters), "watermarks": dict(self.watermarks),
                    "n_events": len(self.events), "sink": self._sink_path}

    def clear(self, kinds: Optional[Iterable[str]] = None) -> None:
        """Drop counters, watermarks and events (the sink file stays: it
        is an append-only log); with ``kinds``, only the events of those
        kinds."""
        with self._lock:
            if kinds is not None:
                drop = set(kinds)
                self.events[:] = [e for e in self.events if e.get("kind") not in drop]
                return
            self.counters.clear()
            self.watermarks.clear()
            self.events.clear()


def get_registry() -> Telemetry:
    global _REGISTRY
    if _REGISTRY is None:
        with _REGISTRY_LOCK:
            if _REGISTRY is None:
                _REGISTRY = Telemetry()
    return _REGISTRY


def enabled() -> bool:
    """Whether telemetry records."""
    return _ENABLED


def enable(sink: Union[str, IO[str], None] = None) -> Telemetry:
    """Turn recording on; ``sink`` (or ``HEAT_TPU_TELEMETRY_SINK``) names a
    JSONL file for the events. Returns the registry."""
    global _ENABLED
    reg = get_registry()
    if sink is None:
        sink = knobs.raw("HEAT_TPU_TELEMETRY_SINK") or None
    if sink is not None:
        try:
            reg.attach_sink(sink)
        except OSError as e:
            import warnings

            warnings.warn(f"heat_tpu_torch.telemetry: cannot open sink {sink!r} ({e}); "
                          "recording in memory only")
    _install_atexit()
    _ENABLED = True
    return reg


def disable() -> None:
    """Turn recording off and close an owned sink; counters and events stay
    (``get_registry().clear()`` drops them)."""
    global _ENABLED
    _ENABLED = False
    get_registry().close_sink()


_atexit_installed = False


def flush(reason: str = "flush") -> Optional[dict]:
    """Write a ``final`` event with the counters and watermarks, so that
    the state of a run that dies is on disk; a no-op when disabled."""
    if not _ENABLED:
        return None
    reg = get_registry()
    snap = reg.snapshot()
    return reg.emit("final", reason, counters=snap["counters"], watermarks=snap["watermarks"])


def _install_atexit() -> None:
    global _atexit_installed
    if not _atexit_installed:
        import atexit

        atexit.register(_atexit_flush)
        _atexit_installed = True


def _atexit_flush() -> None:  # pragma: no cover - runs at interpreter exit
    try:
        if _ENABLED and get_registry()._sink is not None:
            flush("atexit")
        get_registry().close_sink()
    except Exception:
        pass


class _NoopSpan:
    """The shared span of a disabled registry."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def add_fields(self, **fields):
        return self

    def output(self, value):
        return value


_NOOP_SPAN = _NoopSpan()


def _wait_for(values) -> None:
    """Wait for the cards that hold any CUDA tensor of ``values`` (not while
    a CUDA graph is being captured, where waiting is illegal: a span there
    times the capture, as a JAX span inside a trace times the trace)."""
    import torch

    devices = set()
    for v in values:
        tensors = v if isinstance(v, (list, tuple)) else [v]
        for t in tensors:
            t = getattr(t, "larray", t)
            if isinstance(t, torch.Tensor) and t.is_cuda:
                devices.add(t.device)
    if devices and torch.cuda.is_current_stream_capturing():
        return
    for d in devices:
        torch.cuda.synchronize(d)


class Span:
    """A timed region. Tensors registered with :meth:`output` are waited
    for before the clock stops, so ``seconds`` covers their device work."""

    __slots__ = ("name", "fields", "_outputs", "_t0", "_wall0")

    def __init__(self, name: str, fields: Dict[str, Any]):
        self.name = name
        self.fields = fields
        self._outputs: List[Any] = []
        self._t0 = 0.0
        self._wall0 = 0.0

    def add_fields(self, **fields: Any) -> "Span":
        self.fields.update(fields)
        return self

    def output(self, value):
        self._outputs.append(value)
        return value

    def __enter__(self) -> "Span":
        _stack().append(self)
        self._wall0 = time.time()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None and self._outputs:
            _wait_for(self._outputs)
        dt = time.perf_counter() - self._t0
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        parent = stack[-1].name if stack else None
        reg = get_registry()
        if exc_type is not None:
            reg.emit("span_error", self.name, seconds=dt, start_ts=self._wall0,
                     error=repr(exc), **self.fields)
            return False
        reg.add(f"span.{self.name}.count", 1)
        reg.add(f"span.{self.name}.seconds", dt)
        b = self.fields.get("bytes")
        if b:
            reg.add(f"span.{self.name}.bytes", b)
        reg.emit("span", self.name, seconds=dt, depth=len(stack), parent=parent,
                 start_ts=self._wall0, **self.fields)
        return False


def span(name: str, **fields: Any):
    """A telemetry span (context manager); the shared no-op when disabled."""
    if not _ENABLED:
        return _NOOP_SPAN
    return Span(name, fields)


def op_cost(cost_fn, *cost_args, audit: bool = False, use_global: bool = True):
    """The shared preamble of the instrumented sites: ``(cost, fields,
    do_audit)``.

    * ``cost``: the analytic :class:`~.collectives.CollectiveCost`, computed
      only when recording or auditing will read it (None otherwise, so a
      disabled site costs one flag check);
    * ``fields``: the span fields (``cost.as_fields()`` while recording,
      ``{}`` otherwise);
    * ``do_audit``: whether the call runs under :func:`.hlo.audit_call`:
      ``audit=True``, or the global ``HEAT_TPU_HLO_AUDIT`` unless
      ``use_global=False``.
    """
    do_audit = audit or (use_global and hlo.audit_enabled())
    cost = cost_fn(*cost_args) if (_ENABLED or do_audit) else None
    fields = cost.as_fields() if (_ENABLED and cost is not None) else {}
    return cost, fields, do_audit


# collectives issued by this process, by name, whether or not telemetry records
_ISSUED: Dict[str, int] = defaultdict(int)
_ISSUED_LOCK = threading.Lock()


def trace_event(name: str, **fields: Any) -> None:
    """One collective issued by the communication layer (module docstring):
    counted always, observed by the open audits, and a ``traced.<name>``
    counter with one ``collective_trace`` event while telemetry records."""
    with _ISSUED_LOCK:
        _ISSUED[name] += 1
    if hlo._RECORDING:
        hlo._observe(name, fields)
    if not _ENABLED:
        return
    reg = get_registry()
    reg.add(f"traced.{name}", 1)
    reg.emit("collective_trace", name, **fields)


def collective_counts() -> Dict[str, int]:
    """The collectives this process issued since the last reset, by name
    (``allreduce``, ``all_gather``, ``ppermute``, ...)."""
    with _ISSUED_LOCK:
        return dict(_ISSUED)


def reset_collective_counts() -> None:
    with _ISSUED_LOCK:
        _ISSUED.clear()


# -- builds of the program registry ------------------------------------------

# the stage name of one build, the JAX package's backend-compile event
BUILD_STAGE = "backend_compile_duration"
_ACTIVE_WATCHERS: List["CompileWatcher"] = []
_WATCHERS_LOCK = threading.Lock()


def record_build(site: str, seconds: float) -> None:
    """Report one build of a registry program (a graph capture on the
    card, a first call of a signature on the CPU) to every open
    :class:`CompileWatcher`, and as a ``compile`` event while enabled."""
    with _WATCHERS_LOCK:
        watchers = list(_ACTIVE_WATCHERS)
    for w in watchers:
        w._record(BUILD_STAGE, seconds)
    if _ENABLED:
        reg = get_registry()
        reg.add(f"compile.{BUILD_STAGE}", seconds)
        reg.emit("compile", "backend_compile", seconds=seconds, site=site)


class CompileWatcher:
    """Count and time the builds of the program registry made, on any
    thread, while the context is open (whether or not telemetry records).
    ``backend_compiles`` is the number of builds: 0 over a steady state
    that only replays warm programs."""

    def __init__(self):
        self.stages: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.events = 0
        self._lock = threading.Lock()

    @property
    def seconds(self) -> float:
        """Build seconds observed (all stages)."""
        return sum(self.stages.values())

    @property
    def backend_seconds(self) -> float:
        return self.stages.get(BUILD_STAGE, 0.0)

    @property
    def backend_compiles(self) -> int:
        """Builds in the window."""
        return self.counts.get(BUILD_STAGE, 0)

    def _record(self, stage: str, secs: float) -> None:
        with self._lock:
            self.stages[stage] += secs
            self.counts[stage] += 1
            self.events += 1

    def __enter__(self) -> "CompileWatcher":
        with _WATCHERS_LOCK:
            _ACTIVE_WATCHERS.append(self)
        return self

    def __exit__(self, *exc):
        with _WATCHERS_LOCK:
            if self in _ACTIVE_WATCHERS:
                _ACTIVE_WATCHERS.remove(self)
        return False


def measure_compile(fn, *args, **kwargs):
    """Build ``fn`` for ``args`` and time it: ``(seconds, program)``, where
    ``program`` is a :class:`heat_tpu_torch.core.program_cache.Program`
    outside the registry and the seconds cover the first call of this
    signature, its build (on the card the capture, which runs the program
    as a CUDA graph's capture must; on the CPU the call itself)."""
    from ..core.program_cache import Program

    program = fn if isinstance(fn, Program) else Program(getattr(fn, "__name__", "measure"), fn)
    if kwargs:
        raise TypeError("measure_compile: a registry program takes positional tensors only")
    t0 = time.perf_counter()
    program(*args)
    dt = time.perf_counter() - t0
    if _ENABLED:
        get_registry().emit("compile", program.site, seconds=dt, mode="aot")
    return dt, program


# the submodules read the registry machinery above, so they load last
from . import hlo  # noqa: E402
from . import memory  # noqa: E402
from . import report  # noqa: E402
from . import trace  # noqa: E402
from . import cluster  # noqa: E402

export_trace = trace.export_trace
SLO = cluster.SLO
summarize_cluster = cluster.summarize_cluster

if knobs.get("HEAT_TPU_TELEMETRY"):
    enable()
