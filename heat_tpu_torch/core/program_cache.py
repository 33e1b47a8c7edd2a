"""The process-global program registry: a registry of CUDA graphs.

Counterpart of ``heat_tpu/core/program_cache.py``. There, every jitted
program of the framework goes through one memoizing choke point keyed on
``(site, comm, static config)``; each entry retraces inside itself for a
new input signature, and steady-state dispatch is a dict lookup. Here:

* :func:`cached_program` memoizes one :class:`Program` per
  ``(site, comm, key)`` in an LRU registry of at most
  ``HEAT_TPU_PROGRAM_CACHE`` entries, wrapped once by
  :func:`heat_tpu_torch.resilience.wrap_program` (the fault injector, the
  memory preflight and the retry guard when armed);
* **on the card** a :class:`Program` holds one CUDA graph per input
  signature (the shapes and dtypes of its tensors), captured at the first
  call of that signature (the warm-up) on a side stream, with
  ``capture_error_mode="thread_local"``, into a private memory pool of its
  own, and replayed after. That capture is the counterpart of a retrace
  inside a jitted entry. Each call copies its tensors into the graph's
  static inputs (a host tensor crosses to the card in that one copy). The
  result is a clone of the static output, made before the next replay can
  overwrite it. A program that cannot be captured raises at its warm-up,
  naming its site: nothing falls back to eager dispatch;
* **parameters**: with ``params_from=i`` the arguments from position
  ``i`` on are parameters (centres, a training set, weights), passed on
  every call as in the JAX package. Their static buffers are one set,
  shared by every graph of every program with the same site, ``comm`` and
  ``params_key`` (the ladder buckets of one endpoint), and a parameter is
  copied again (device to device) only when the tensor object or its
  version counter changes: a versioned publish, or another caller of the
  same set. Only tensors on the card are skipped so: a host tensor is
  copied on every call, since writes through numpy into its buffer do not
  move its version counter. Programs that share a set also share the lock
  that orders their calls;
* **on the CPU** a :class:`Program` calls the plain callable;
* every build (a capture on the card, a first call of a signature on the
  CPU) is reported to :class:`heat_tpu_torch.telemetry.CompileWatcher`
  as one ``backend_compile_duration`` event, so that a steady state is
  checked to build nothing;
* the counters ``program_cache.hits``/``.misses``/``.evictions`` and the
  per-site retrace counts feed telemetry as in the JAX package.

XLA's knobs of ``jax.jit`` (``out_shardings``, ``static_argnums``,
``donate``) have no counterpart: a graph copies its inputs. XLA's
per-call precision has one: ``tf32=False`` captures the program's
products with TF32 off (``torch.backends.cuda.matmul.allow_tf32``, the
caller's flag restored after the capture; a replay does not read it). The serving
endpoints go through this registry; the port's other modules keep their
own caches (``regression.Lasso``'s epoch graph) until item 13's fusion
work.
"""

from __future__ import annotations

import threading
import time
import weakref
from collections import OrderedDict
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from .. import _build, resilience, telemetry
from .. import _knobs as knobs

__all__ = [
    "DEFAULT_MAXSIZE",
    "Program",
    "cached_program",
    "clear",
    "enable_persistent_cache",
    "persistent_cache_dir",
    "program_key",
    "reset",
    "site_stats",
    "stats",
]

DEFAULT_MAXSIZE = 512

_LOCK = threading.RLock()
_PROGRAMS: "OrderedDict[Tuple, Callable]" = OrderedDict()
_STATS = {"hits": 0, "misses": 0, "evictions": 0}
_SITE_STATS: dict = {}
# the shared parameter sets, by (site, comm, params_key); a set lives as
# long as a program of the registry holds it
_SHARED: "weakref.WeakValueDictionary[Tuple, _Shared]" = weakref.WeakValueDictionary()
# TF32 is a process-global flag: captures that set it take turns
_TF32_LOCK = threading.Lock()


def _maxsize() -> int:
    n = knobs.get("HEAT_TPU_PROGRAM_CACHE")
    return n if n > 0 else DEFAULT_MAXSIZE


def _signature(args: tuple) -> Tuple:
    sig = []
    for a in args:
        if not isinstance(a, torch.Tensor):
            raise TypeError(f"a registry program takes tensors, got {type(a).__name__}")
        sig.append((tuple(a.shape), a.dtype))
    return tuple(sig)


def _copy_into(static: list, last: list, args) -> None:
    """Copy ``args`` into their static buffers, skipping a tensor on the
    card that is the very one copied last time, unchanged."""
    for i, a in enumerate(args):
        prev = last[i]
        if prev is not None and prev[0] is a and prev[1] == a._version:
            continue
        dst = static[i]
        if a.shape != dst.shape or a.dtype != dst.dtype:  # copy_ would broadcast or cast
            raise ValueError(f"program cache: a {tuple(a.shape)} {a.dtype} tensor does not fit "
                             f"its static buffer {tuple(dst.shape)} {dst.dtype}")
        dst.copy_(a)
        last[i] = (a, a._version) if a.is_cuda else None


class _Shared:
    """What the programs of one parameter set hold in common on the card:
    the lock that orders their calls, the stream of the last call, and
    the parameters' static buffers (made at the first capture)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.stream = None
        self.raw_stream = None
        self.static: Optional[list] = None
        self.last: list = []

    def enter(self, device: torch.device, params: tuple) -> None:
        """Order this call after the last one (also when it ran on another
        stream), then copy in the parameters that changed. Under ``lock``."""
        # the raw handle is one call into C; torch.cuda.current_stream builds
        # a Stream under a device guard, which the batcher would pay a batch
        raw = torch._C._cuda_getCurrentRawStream(device.index)
        if raw != self.raw_stream:
            stream = torch.cuda.current_stream(device)
            if self.stream is not None:
                stream.wait_stream(self.stream)
            self.stream, self.raw_stream = stream, raw
        if not params:
            return
        if self.static is None:
            self.static = [torch.empty(p.shape, dtype=p.dtype, device=device) for p in params]
            self.last = [None] * len(params)
        elif len(params) != len(self.static):
            raise ValueError(f"program cache: {len(params)} parameters for a shared set of "
                             f"{len(self.static)}")
        _copy_into(self.static, self.last, params)

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.static or ())


class _Graph:
    """One captured signature: static inputs, the CUDA graph with its own
    memory pool, and the static output. ``params`` are the shared static
    parameter buffers, read by the graph and not owned by it."""

    def __init__(self, site: str, fn: Callable, inputs: tuple, params: list,
                 device: torch.device, tf32: Optional[bool]):
        self.static_in = [torch.empty(a.shape, dtype=a.dtype, device=device) for a in inputs]
        self.last: list = [None] * len(inputs)
        self.copy_in(inputs)
        args = tuple(self.static_in) + tuple(params)
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        flip = tf32 is not None
        if flip:
            _TF32_LOCK.acquire()
            flag = torch.backends.cuda.matmul.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = bool(tf32)
        try:
            # one eager run on the side stream first: cuBLAS handles, lazy
            # module loads and the allocator's first blocks happen outside
            # the capture
            with torch.cuda.stream(side):
                fn(*args)
            torch.cuda.current_stream(device).wait_stream(side)
            torch.cuda.synchronize(device)
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(device)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph, pool=torch.cuda.graph_pool_handle(), stream=side,
                                  capture_error_mode="thread_local"):
                self.static_out = fn(*args)
        except Exception as e:
            raise RuntimeError(f"program cache: site {site!r} could not be captured as a CUDA "
                               f"graph for inputs {_signature(inputs + tuple(params))}: {e}") from e
        finally:
            if flip:
                torch.backends.cuda.matmul.allow_tf32 = flag
                _TF32_LOCK.release()
        # the pool's segments, and the static inputs allocated before it
        self.pool_bytes = max(0, torch.cuda.memory_reserved(device) - reserved) + sum(
            t.numel() * t.element_size() for t in self.static_in)

    def copy_in(self, inputs: tuple) -> None:
        _copy_into(self.static_in, self.last, inputs)

    def output(self):
        out = self.static_out
        if isinstance(out, (tuple, list)):
            return type(out)(t.clone() for t in out)
        return out.clone()


class Program:
    """One registry entry: ``fn`` over positional tensors, a CUDA graph
    per input signature on the card, the plain call on the CPU (module
    docstring). The arguments from ``params_from`` on are parameters in
    the static buffers of ``shared``. ``cost_bytes`` is the analytic bytes
    of one call, what
    :func:`heat_tpu_torch.resilience.memory_guard.program_bytes` reports
    on the CPU."""

    def __init__(self, site: str, fn: Callable, *, cost_bytes: int = 0,
                 params_from: Optional[int] = None, shared: Optional[_Shared] = None,
                 tf32: Optional[bool] = None):
        self.site = site
        self.fn = fn
        self.cost_bytes = int(cost_bytes)
        self.params_from = params_from
        self.shared = shared if shared is not None else _Shared()
        self.tf32 = tf32
        self.builds = 0
        self._graphs: Dict[Tuple, _Graph] = {}
        self._seen: set = set()  # signatures called on the CPU

    def __call__(self, *args):
        sig = _signature(args)
        device = next((a.device for a in args if a.is_cuda), None)
        if device is None:
            if sig in self._seen:
                return self.fn(*args)
            t0 = time.perf_counter()
            out = self.fn(*args)
            with self.shared.lock:
                fresh = sig not in self._seen
                self._seen.add(sig)
            if fresh:
                self._built(time.perf_counter() - t0)
            return out
        n = len(args) if self.params_from is None else self.params_from
        inputs, params = args[:n], args[n:]
        key = (device.index, sig)
        with self.shared.lock:
            self.shared.enter(device, params)
            graph = self._graphs.get(key)
            if graph is None:
                t0 = time.perf_counter()
                graph = self._graphs[key] = _Graph(self.site, self.fn, inputs,
                                                   self.shared.static or [], device, self.tf32)
                graph.graph.replay()
                self._built(time.perf_counter() - t0)
            else:
                graph.copy_in(inputs)
                graph.graph.replay()
            return graph.output()

    def _built(self, seconds: float) -> None:
        self.builds += 1
        telemetry.record_build(self.site, seconds)

    def program_bytes(self, args: tuple) -> int:
        """The pool bytes of the graph ``args`` replay on the card (0 before
        its capture), its static inputs included and the shared parameters
        not; ``cost_bytes`` on the CPU."""
        if not any(isinstance(a, torch.Tensor) and a.is_cuda for a in args):
            return self.cost_bytes
        device = next(a.device for a in args if a.is_cuda)
        graph = self._graphs.get((device.index, _signature(args)))
        return graph.pool_bytes if graph is not None else 0

    def param_bytes(self) -> int:
        """The bytes of the parameter set's static buffers on the card,
        shared with every program of the set (0 before its first capture)."""
        return self.shared.nbytes()


def program_key(site: str, key: Any, comm: Any = None) -> Tuple:
    """The registry key of one program: ``comm`` by identity, ``key`` the
    caller's static configuration (anything that changes the program)."""
    return (site, comm, key)


def cached_program(site: str, key: Any, build: Callable[[], Callable], *, comm: Any = None,
                   cost_bytes: int = 0, params_from: Optional[int] = None,
                   params_key: Any = None, tf32: Optional[bool] = None) -> Callable:
    """The memoized program of ``(site, comm, key)``, built on a miss:
    ``build()`` returns the callable over positional tensors and runs only
    then (cheap, no side effects; nothing is captured until the program's
    first call). ``cost_bytes`` is its analytic bytes a call on the CPU.
    With ``params_from``, the arguments from that position on are
    parameters whose static buffers on the card are shared by every
    program of ``(site, comm, params_key)``; ``tf32`` sets TF32 for the
    capture (module docstring). The returned callable is the
    :class:`Program` wrapped by ``resilience.wrap_program``; two calls
    with the same key and other shapes share the entry and capture a graph
    each."""
    full_key = program_key(site, key, comm=comm)
    evicted = 0
    miss = False
    with _LOCK:
        fn = _PROGRAMS.get(full_key)
        srow = _SITE_STATS.setdefault(site, {"hits": 0, "misses": 0})
        if fn is not None:
            _PROGRAMS.move_to_end(full_key)
            _STATS["hits"] += 1
            srow["hits"] += 1
        else:
            miss = True
            _STATS["misses"] += 1
            srow["misses"] += 1
            shared = None
            if params_from is not None:
                skey = (site, comm, params_key)
                shared = _SHARED.get(skey)
                if shared is None:
                    shared = _SHARED[skey] = _Shared()
            fn = resilience.wrap_program(site, Program(site, build(), cost_bytes=cost_bytes,
                                                       params_from=params_from, shared=shared,
                                                       tf32=tf32))
            maxsize = _maxsize()
            while len(_PROGRAMS) >= maxsize:
                _PROGRAMS.popitem(last=False)
                _STATS["evictions"] += 1
                evicted += 1
            _PROGRAMS[full_key] = fn
    if telemetry.enabled():
        reg = telemetry.get_registry()
        if miss:
            reg.add("program_cache.misses", 1)
            reg.add(f"program_cache.retrace.{site}", 1)
            reg.emit("program_cache", site, event="retrace", key=repr(key))
        else:
            reg.add("program_cache.hits", 1)
        if evicted:
            reg.add("program_cache.evictions", evicted)
            reg.emit("program_cache", site, event="eviction", count=evicted)
    return fn


def stats() -> dict:
    """``{"hits", "misses", "evictions", "size", "maxsize", "sites"}``, the
    per-site hits and misses under ``sites``."""
    with _LOCK:
        return {"hits": _STATS["hits"], "misses": _STATS["misses"],
                "evictions": _STATS["evictions"], "size": len(_PROGRAMS),
                "maxsize": _maxsize(),
                "sites": {s: dict(row) for s, row in _SITE_STATS.items()}}


def site_stats(prefix: str) -> dict:
    """``{"hits", "misses"}`` summed over the sites named ``prefix...``:
    ``site_stats("serve.")`` is the serving front end's oracle (a steady
    state moves only the hits)."""
    with _LOCK:
        out = {"hits": 0, "misses": 0}
        for s, row in _SITE_STATS.items():
            if s.startswith(prefix):
                out["hits"] += row["hits"]
                out["misses"] += row["misses"]
        return out


def reset() -> None:
    """Drop every program (and its graphs) and zero the counters."""
    with _LOCK:
        _PROGRAMS.clear()
        _SHARED.clear()
        _STATS.update(hits=0, misses=0, evictions=0)
        _SITE_STATS.clear()


clear = reset


def persistent_cache_dir() -> str:
    """The on-disk cache of the port: the kernel build directory."""
    return str(_build.BUILD_DIR)


def enable_persistent_cache() -> dict:
    """The counterpart of the JAX package's persistent compilation cache,
    which has no XLA to feed here. What a process of the port builds once
    and a second process must find on disk are the CUDA kernels: this
    builds every ``csrc/`` library missing from the kernel build directory
    (beside the package, shared by every process of one checkout) and
    returns ``{"dir", "compiled"}``, where ``compiled`` counts the
    libraries this process has compiled so far (0 when it found them all
    built). Needs ``nvcc``; a serving replica on the card calls it at
    start. CUDA graphs live in one process and are captured by each."""
    _build.build()
    return {"dir": persistent_cache_dir(), "compiled": _build.compiled_count()}
