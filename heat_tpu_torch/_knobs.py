"""The registry of every ``HEAT_TPU_*`` environment knob the port reads.

Counterpart of ``heat_tpu/_knobs.py``, kept as the port's own copy: the
port imports nothing of the JAX package. Only the knobs the port reads are
registered, each with the JAX entry's name, type, default and
:class:`Tunable` where the meaning is the same (the autotuner's search
space is declared next to the knob, as there).

A leaf module (stdlib only), importable from anywhere in the package. Its
public face is :mod:`heat_tpu_torch.core.knobs`, a re-export. Every read
happens at call time and consults the in-process **overlay** first
(:func:`set_override`, :func:`overlay`: tuned values, never written to
``os.environ``), then the environment, so a variable set after import (a
test's ``monkeypatch.setenv``) takes effect at the next call::

    from heat_tpu_torch import _knobs as knobs
    knobs.get("HEAT_TPU_RING_OVERLAP")       # typed parse
    knobs.raw("HEAT_TPU_HBM_BUDGET", "")     # the raw string, for own parsers
    with knobs.overlay({"HEAT_TPU_FUSION": "0"}):
        ...                                   # every read sees "0" here
"""

from __future__ import annotations

import contextlib
import os
import threading
from dataclasses import dataclass, field
from typing import Dict, Iterable, Optional, Tuple, Union

__all__ = [
    "FALSY",
    "Knob",
    "REGISTRY",
    "TRUTHY",
    "Tunable",
    "clear_overrides",
    "default_raw",
    "get",
    "markdown_table",
    "names",
    "overlay",
    "overrides",
    "raw",
    "set_override",
    "tunables",
]

# default-on knobs treat anything outside FALSY as on; default-off knobs
# need an explicit TRUTHY (the JAX package's conventions)
FALSY = ("0", "false", "off", "no")
TRUTHY = ("1", "true", "yes", "on")


@dataclass(frozen=True)
class Tunable:
    """Autotuner metadata of one knob: ``values`` are raw environment
    strings (what the tuner installs in the overlay while it searches) and
    ``kind`` the constraint class of the trial validator: ``exact`` (every
    value leaves results bit-identical), ``lossy`` (values other than
    ``exact_value`` may change numerics; searched only under a stated error
    budget) or ``neutral`` (scheduling and throughput only)."""

    values: Tuple[str, ...]
    kind: str  # 'exact' | 'lossy' | 'neutral'
    exact_value: Optional[str] = None  # lossy knobs: the exact-semantics value


@dataclass(frozen=True)
class Knob:
    """One declared environment knob. ``type`` is ``bool``, ``int``,
    ``float``, ``str``, ``enum``, ``bytes`` (a byte count with K/M/G/T
    suffixes, parsed by its owner) or ``spec`` (a mini-language parsed by
    its owner); ``default`` is the value when the variable is unset or
    malformed (None: the feature is off); ``tunable`` is the autotuner's
    candidate space (perf-relevant knobs only)."""

    name: str
    type: str
    default: Union[bool, int, float, str, None]
    doc: str
    choices: Tuple[str, ...] = field(default=())
    tunable: Optional[Tunable] = None


REGISTRY: Dict[str, Knob] = {}


def _register(name: str, type: str, default, doc: str, *, choices: Tuple[str, ...] = (),
              tunable: Optional[Tunable] = None) -> None:
    if name in REGISTRY:
        raise ValueError(f"knob {name!r} registered twice")
    if not name.startswith("HEAT_TPU_"):
        raise ValueError(f"knob {name!r} must be namespaced HEAT_TPU_*")
    if tunable is not None:
        if tunable.kind not in ("exact", "lossy", "neutral"):
            raise ValueError(f"knob {name!r}: tunable kind {tunable.kind!r} is not one of "
                             "exact/lossy/neutral")
        if not tunable.values or not all(isinstance(v, str) and v for v in tunable.values):
            raise ValueError(f"knob {name!r}: tunable values must be non-empty raw strings, "
                             f"got {tunable.values!r}")
        if tunable.kind == "lossy" and tunable.exact_value is None:
            raise ValueError(f"knob {name!r}: a lossy tunable must declare its exact-semantics "
                             "value")
    REGISTRY[name] = Knob(name, type, default, doc, choices=choices, tunable=tunable)


_register(
    "HEAT_TPU_TELEMETRY", "bool", False,
    "Turn telemetry recording on at `import heat_tpu_torch` (counters, "
    "watermarks and events; one flag check per call site when off).",
)
_register(
    "HEAT_TPU_TELEMETRY_SINK", "str", None,
    "JSONL file that telemetry events stream to; unset records in memory only.",
)
_register(
    "HEAT_TPU_HLO_AUDIT", "bool", False,
    "Audit every instrumented collective site (telemetry/hlo.py): record the "
    "collectives each call issues and compare their wire bytes with the "
    "analytic cost model, as `audit=True` does for one call.",
)
_register(
    "HEAT_TPU_HLO_TOLERANCE", "float", 0.1,
    "Relative wire-byte drift the collective audit tolerates before it "
    "flags a site.",
)
_register(
    "HEAT_TPU_DCN_PREMIUM", "float", 8.0,
    "Relative cost of one cross-node wire byte against one in-node byte in "
    "the analytic cost model (telemetry/collectives.weighted_wire).",
)
_register(
    "HEAT_TPU_SLO_WINDOW_S", "float", 60.0,
    "Rolling window in seconds over which Router.cluster_summary() computes "
    "SLO burn rates (deltas of the cumulative per-replica scrapes; the first "
    "call covers each replica's lifetime).",
)
_register(
    "HEAT_TPU_SLO_BURN_THRESHOLD", "float", 1.0,
    "Burn rate above which Router.check_slos() emits a `slo_burn` event "
    "(1.0 = spending the error budget exactly on schedule).",
)
# -- fusion and relayout planning (core/fusion.py, core/relayout_planner.py) ----

_register(
    "HEAT_TPU_FUSION", "bool", True,
    "Elementwise defer-and-fuse dispatch (core/fusion.py): a chain of "
    "elementwise ops flushes as one cached program at its first read. `0` "
    "restores pure-eager dispatch bit for bit.",
    tunable=Tunable(("1", "0"), "exact"),
)
_register(
    "HEAT_TPU_FUSION_REDUCE", "bool", True,
    "Through-reduction absorption and the matmul/moments epilogue grafts of "
    "core/fusion.py. `0` restores flush-at-reduction dispatch.",
    tunable=Tunable(("1", "0"), "exact"),
)
_register(
    "HEAT_TPU_FUSION_DEPTH", "int", 16,
    "Max fused-chain depth before a forced flush (node cap is 4x this).",
    tunable=Tunable(("4", "8", "16", "32", "64"), "exact"),
)
_register(
    "HEAT_TPU_RELAYOUT_PLAN", "enum", "auto",
    "Relayout planning policy (core/relayout_planner.py): `auto` picks from "
    "tensor size against the memory budget; the rest force one "
    "decomposition.",
    choices=("auto", "monolithic", "chunked", "alltoall"),
    tunable=Tunable(("auto", "monolithic", "chunked", "alltoall"), "exact"),
)

# -- compressed and tiered collectives (core/collective_prec.py, core/topology.py)

_register(
    "HEAT_TPU_COLLECTIVE_PREC", "enum", "off",
    "Wire precision of the payload-moving collectives of the surfaces that "
    "resolve one (resplit, DataParallel, DASO, ZeroOptimizer, the cross-node "
    "tier): bf16 cast-move-upcast, int8 / blockwise max-abs quantization "
    "(core/collective_prec.py). Exact-semantics sites move exact.",
    choices=("off", "bf16", "int8", "blockwise"),
    tunable=Tunable(("off", "bf16", "int8", "blockwise"), "lossy", exact_value="off"),
)
_register(
    "HEAT_TPU_COLLECTIVE_PREC_BLOCK", "int", 128,
    "Blockwise-quantization scale granularity in elements.",
    tunable=Tunable(("64", "128", "256"), "lossy", exact_value="128"),
)
_register(
    "HEAT_TPU_TOPOLOGY", "str", None,
    "Declared 2-level (node x local) factorization of the ranks, e.g. `2x4` "
    "(core/topology.py). Unset auto-detects: one node a host when the ranks "
    "span several hosts, else the emulated 2-node split of an even world. "
    "Malformed or mismatched values fall back to detection.",
)
_register(
    "HEAT_TPU_HIERARCHICAL", "bool", False,
    "Tiered lowering of the sum all-reduce, all-gather, reduce-scatter and "
    "all-to-all of TorchCommunication: in-node reduce-scatter -> cross-node "
    "collective over the 1/local shard -> in-node all-gather, exact inside "
    "the node, HEAT_TPU_HIERARCHICAL_PREC across. `0` keeps the flat path.",
    tunable=Tunable(("0", "1"), "exact"),
)
_register(
    "HEAT_TPU_HIERARCHICAL_PREC", "str", None,
    "Wire precision of the cross-node tier of a tiered collective: off | bf16 "
    "| int8 | blockwise. Unset inherits HEAT_TPU_COLLECTIVE_PREC; the in-node "
    "tier always moves exact.",
    tunable=Tunable(("off", "bf16", "int8", "blockwise"), "lossy", exact_value="off"),
)

# -- FSDP and pipeline training (parallel/fsdp.py, nn/fsdp.py, nn/pipeline.py)

_register(
    "HEAT_TPU_FSDP", "bool", False,
    "Full FSDP parameter sharding in nn.FSDP: parameters live as flat 1/p "
    "shards and each stage's weights are all-gathered just in time. `0` "
    "keeps the replicated DataParallel step.",
    tunable=Tunable(("0", "1"), "exact"),
)
_register(
    "HEAT_TPU_FSDP_PREFETCH", "int", 1,
    "FSDP gather-prefetch depth: stage k's weight all-gather is issued "
    "(asynchronously) during stage k-d's compute, so at most d+1 stages' "
    "gathered weights are live. Outputs are bit-identical at every depth.",
    tunable=Tunable(("0", "1", "2"), "neutral"),
)
_register(
    "HEAT_TPU_FSDP_PREC", "str", None,
    "Wire precision of FSDP weight gathers (and their reduce-scatters) for "
    "partition rules that pin none: off | bf16 | int8 | blockwise. Unset "
    "inherits the cross-node chain under HEAT_TPU_HIERARCHICAL=1, else `off`.",
    tunable=Tunable(("off", "bf16", "int8", "blockwise"), "lossy", exact_value="off"),
)
_register(
    "HEAT_TPU_PIPELINE_SCHEDULE", "enum", "gpipe",
    "Pipeline-training schedule of nn.Pipeline (parallel/schedule.py "
    "tables): `gpipe` (forward wave, flush, backward wave) or `1f1b` (the "
    "same results bit for bit, a stash of min(S, M) microbatches and fewer "
    "steady-window bubble ticks).",
    choices=("gpipe", "1f1b"),
    tunable=Tunable(("gpipe", "1f1b"), "exact"),
)
_register(
    "HEAT_TPU_PIPELINE_STAGES", "int", 0,
    "Stage count of the pipeline mapping (parallel/schedule.plan_stages). 0 "
    "= auto: the node count of an active 2-level topology, else one stage a "
    "rank. Must divide the world size.",
)
_register(
    "HEAT_TPU_PIPELINE_MICROBATCHES", "int", 0,
    "Microbatch count M of nn.Pipeline steps. 0 = auto (the stage count). "
    "Must divide the batch.",
    tunable=Tunable(("0", "2", "4", "8"), "neutral"),
)
_register(
    "HEAT_TPU_RING_OVERLAP", "bool", True,
    "The rings (CholeskyQR2's Gram ring, the ring distances) issue each hop "
    "before its tile's product and skip the dead last hop; `0` restores the "
    "serial schedule. The tiles are the same either way.",
    tunable=Tunable(("1", "0"), "exact"),
)
_register(
    "HEAT_TPU_CDIST_PREC", "enum", "bf16x3",
    "The cdist product on the card: `bf16x3` and `high` the 3xTF32 `wgmma` "
    "kernel (exact f32 products to ~2^-22), `default` one TF32 pass, "
    "`highest` the f32 FMA kernel. An unknown value warns and keeps `bf16x3`.",
    choices=("bf16x3", "default", "high", "highest"),
    tunable=Tunable(("bf16x3", "default", "high", "highest"), "lossy", exact_value="highest"),
)
_register(
    "HEAT_TPU_HBM_BUDGET", "bytes", None,
    "Per-device memory budget in bytes (K/M/G/T suffixes, e.g. `8G`). Sizes "
    "the temporaries (`memory_guard.temp_budget`, a quarter of it) and so "
    "the out-of-core chunks. Unset or malformed: no budget.",
)
_register(
    "HEAT_TPU_SPARSE_DENSE_THRESHOLD", "float", 0.25,
    "Density (nnz / rows*cols) above which the eNeighbour graph.Laplacian "
    "takes the dense pipeline.",
)
_register(
    "HEAT_TPU_SPARSE_SPMV_PREC", "enum", "off",
    "Wire precision of the float values in the sparse spmv/spmm "
    "collectives (sparse/ops.py): `off` (exact, the default) or `bf16` (the "
    "gathered operand moves as its bf16 bits, the all-reduce sums bf16).",
    choices=("off", "bf16"),
    tunable=Tunable(("off", "bf16"), "lossy", exact_value="off"),
)
_register(
    "HEAT_TPU_STREAM_CHUNK_ROWS", "int", 0,
    "streaming.ChunkStream: rows per out-of-core chunk. 0 = auto-size so "
    "the chunk's bytes fit memory_guard.temp_budget().",
)
_register(
    "HEAT_TPU_STREAM_DRAIN_TIMEOUT", "float", 60.0,
    "streaming.rolling_update: seconds an old replica may take to drain "
    "its backlog before the roll fails loudly.",
)

# -- the program cache and the guarded dispatch --------------------------------

_register(
    "HEAT_TPU_PROGRAM_CACHE", "int", 512,
    "Max entries of the program registry (core/program_cache.py); the least "
    "recently used entry, with its CUDA graphs, is evicted beyond it.",
)
_register(
    "HEAT_TPU_RETRIES", "int", 0,
    "Retry budget of a guarded dispatch for transient faults "
    "(resilience/guard.py); 0 = retries off.",
)
_register(
    "HEAT_TPU_RETRY_BASE", "float", 0.05,
    "First retry backoff in seconds (doubles per attempt, jittered).",
)
_register(
    "HEAT_TPU_RETRY_CAP", "float", 2.0,
    "Retry backoff ceiling in seconds.",
)
_register(
    "HEAT_TPU_FAULTS", "spec", None,
    "Deterministic fault-injection spec installed at `import heat_tpu_torch` "
    "(resilience/faults.py), e.g. `serve.*:kind=reset:calls=1`.",
)

# -- serving (serve/, serve/net/) ------------------------------------------------

_register(
    "HEAT_TPU_SERVE_MAX_BATCH", "int", 64,
    "Top bucket of the serving micro-batch ladder (serve/server.py).",
    tunable=Tunable(("16", "32", "64", "128"), "neutral"),
)
_register(
    "HEAT_TPU_SERVE_LADDER", "str", None,
    "Explicit comma-separated bucket ladder; unset derives powers of two up "
    "to the max batch.",
)
_register(
    "HEAT_TPU_SERVE_MAX_WAIT_MS", "float", 2.0,
    "Micro-batch gather window in milliseconds.",
    tunable=Tunable(("0.5", "1.0", "2.0", "4.0"), "neutral"),
)
_register(
    "HEAT_TPU_SERVE_QUEUE_MAX", "int", 1024,
    "Admission bound on pending serving requests (503-style shed beyond it).",
    tunable=Tunable(("256", "1024", "4096"), "neutral"),
)
_register(
    "HEAT_TPU_SERVE_EXACT", "bool", True,
    "Batch-shape-stable serving forms (batched == solo bit for bit); `0` "
    "selects the GEMM forms (TF32 off).",
    tunable=Tunable(("1", "0"), "lossy", exact_value="1"),
)
_register(
    "HEAT_TPU_SERVE_NET_PORT", "int", 0,
    "HTTP listen port of a serving replica; 0 binds an ephemeral port, "
    "printed in the replica's ready line.",
)
_register(
    "HEAT_TPU_SERVE_NET_REPLICAS", "int", 2,
    "Default replica-process count of serve.net.ReplicaPool.",
)
_register(
    "HEAT_TPU_SERVE_NET_POLL_MS", "float", 25.0,
    "Router /stats poll interval in milliseconds (least-loaded scores, "
    "health probes of evicted replicas).",
    tunable=Tunable(("10", "25", "50", "100"), "neutral"),
)
_register(
    "HEAT_TPU_SERVE_NET_RETRIES", "int", 2,
    "Router sibling-retry cap after a 503 shed or a refused connection.",
)
_register(
    "HEAT_TPU_AUTOSCALE_MIN", "int", 1,
    "Lower replica bound of serve.net.AutoscaleController: scale-down "
    "clamps here, so a trough never leaves the endpoint cold.",
)
_register(
    "HEAT_TPU_AUTOSCALE_MAX", "int", 4,
    "Upper replica bound of the autoscale controller; a tick clamped at it "
    "is counted (`clamped_max`).",
)
_register(
    "HEAT_TPU_AUTOSCALE_TICK_S", "float", 1.0,
    "Control-loop period of AutoscaleController.start() in seconds.",
)
_register(
    "HEAT_TPU_AUTOSCALE_UP_COOLDOWN_S", "float", 5.0,
    "Minimum seconds between successive scale-ups (the new replica warms "
    "and absorbs load first).",
)
_register(
    "HEAT_TPU_AUTOSCALE_DOWN_COOLDOWN_S", "float", 30.0,
    "Minimum seconds after any scaling action before a scale-down "
    "(asymmetric hysteresis: down much slower than up).",
)
_register(
    "HEAT_TPU_AUTOSCALE_BACKLOG_HIGH", "float", 4.0,
    "Per-replica backlog (queued + in flight per live replica) above which "
    "a tick counts toward the scale-up streak; an `slo_burn` breach scales "
    "up at once.",
)
_register(
    "HEAT_TPU_AUTOSCALE_BACKLOG_TICKS", "int", 2,
    "Consecutive over-backlog ticks before a backlog-driven scale-up.",
)
_register(
    "HEAT_TPU_AUTOSCALE_IDLE_LOW", "float", 0.5,
    "Per-replica backlog below which a tick counts toward the drain-idle "
    "streak of a scale-down; any shed in the tick resets the streak.",
)
_register(
    "HEAT_TPU_AUTOSCALE_IDLE_TICKS", "int", 5,
    "Consecutive idle ticks before a scale-down.",
)
_register(
    "HEAT_TPU_AUTOSCALE_SPAWN_RETRIES", "int", 2,
    "Extra attempts of ReplicaPool.spawn() after a replica dies during "
    "warm-up (each failure reaped, with exponential backoff).",
)
_register(
    "HEAT_TPU_SERVE_PRIORITY_WEIGHTS", "str", "",
    "Priority-class weights of the router's weighted-fair admission queue, "
    "e.g. `latency=8,bulk=1`. Empty: every class weighs 1.0 (first in, "
    "first out). Dispatch is smooth weighted round-robin over the nonempty "
    "classes; sheds take the newest job of the lowest-weight class first.",
)
_register(
    "HEAT_TPU_SERVE_PRIORITY_QUEUE_MAX", "int", 0,
    "Bound on the router's admission queue (0 = unbounded). When full, an "
    "arriving job sheds the newest queued job of the lowest-weight class "
    "strictly below its own weight, or is shed itself.",
)
_register(
    "HEAT_TPU_HEDGE_ENABLE", "bool", False,
    "Hedged retries (router): after the hedge delay a straggling first "
    "attempt is duplicated to an idle sibling; the first answer wins and the "
    "loser's connection is closed. Needs idempotent endpoints.",
)
_register(
    "HEAT_TPU_HEDGE_DELAY_MS", "float", 0.0,
    "Fixed hedge delay in milliseconds; 0 derives it from the endpoint's "
    "observed p95 once HEAT_TPU_HEDGE_MIN_SAMPLES completions exist.",
)
_register(
    "HEAT_TPU_HEDGE_MAX_FRACTION", "float", 0.05,
    "Cap on hedged requests as a fraction of completed requests.",
)
_register(
    "HEAT_TPU_HEDGE_MIN_SAMPLES", "int", 32,
    "Completions an endpoint needs before a p95-derived hedge delay is "
    "trusted.",
)
_register(
    "HEAT_TPU_TRACE_REQUESTS", "bool", True,
    "Record request traces (serve/tracing.py) while telemetry records; "
    "answers are the same bits either way.",
)
_register(
    "HEAT_TPU_TRACE_SAMPLE", "float", 1.0,
    "Ingress trace-sampling rate in [0, 1], decided once where the id is "
    "minted.",
)


_register(
    "HEAT_TPU_AUTOTUNE", "bool", False,
    "Arm the measured-feedback knob autotuner (heat_tpu_torch/autotune): "
    "program-registry misses and Server construction consult the tuning "
    "database (warm start) and `autotune.tune()` runs measured trials. Off, "
    "dispatch is bit for bit the untuned path: one flag check on a registry "
    "miss, no database reads.",
)
_register(
    "HEAT_TPU_TUNE_DB", "str", None,
    "Directory of the persistent tuning database (atomic-swap JSON records "
    "keyed by program signature, world and backend). A second process "
    "pointed at a populated database starts tuned with zero measured trials.",
)
_register(
    "HEAT_TPU_AUTOTUNE_TRIALS", "int", 5,
    "Measured trials per surviving candidate config (median of k with MAD "
    "outlier rejection).",
)
_register(
    "HEAT_TPU_AUTOTUNE_BUDGET", "float", None,
    "Ambient max amax-normalized relative error the tuner may trade for "
    "speed when the caller states none. Unset = exact only: lossy knob "
    "values are never searched.",
)

# -- the overlay ---------------------------------------------------------------
# Tuned values are installed here, in front of the environment, so every
# consumer of the registry sees them through the reads it already makes. The
# overlay never writes os.environ (subprocesses inherit only what a caller
# exports).

_OVERRIDES: Dict[str, str] = {}
_OVERRIDE_LOCK = threading.RLock()


def _check(name: str) -> None:
    if name not in REGISTRY:
        raise KeyError(f"{name!r} is not a registered HEAT_TPU knob: declare it in "
                       "heat_tpu_torch/_knobs.py before overriding it")


def overrides() -> Dict[str, str]:
    """A snapshot of the overlay (knob name -> raw string)."""
    with _OVERRIDE_LOCK:
        return dict(_OVERRIDES)


def set_override(name: str, value: Optional[str]) -> None:
    """Install one overlay entry, or with ``None`` remove it. The name must
    be registered."""
    _check(name)
    with _OVERRIDE_LOCK:
        if value is None:
            _OVERRIDES.pop(name, None)
        else:
            _OVERRIDES[name] = str(value)


def clear_overrides(names_: Optional[Iterable[str]] = None) -> None:
    """Drop the whole overlay, or just ``names_``."""
    with _OVERRIDE_LOCK:
        if names_ is None:
            _OVERRIDES.clear()
        else:
            for n in names_:
                _OVERRIDES.pop(n, None)


@contextlib.contextmanager
def overlay(mapping: Dict[str, Optional[str]]):
    """Install ``mapping`` in the overlay for the block and restore the
    previous entries (their absence too) after it. Every name is checked
    before anything is installed."""
    with _OVERRIDE_LOCK:
        for n in mapping:
            _check(n)
        prev = {n: _OVERRIDES.get(n) for n in mapping}
        for n, v in mapping.items():
            set_override(n, v)
    try:
        yield
    finally:
        with _OVERRIDE_LOCK:
            for n, v in prev.items():
                if v is None:
                    _OVERRIDES.pop(n, None)
                else:
                    _OVERRIDES[n] = v


# -- reads ---------------------------------------------------------------------


def names() -> frozenset:
    """Every registered knob name."""
    return frozenset(REGISTRY)


def tunables() -> Dict[str, Knob]:
    """The knobs that carry autotuner metadata."""
    return {n: k for n, k in REGISTRY.items() if k.tunable is not None}


def default_raw(name: str) -> str:
    """The raw string a knob has now without tuning: the overlay or
    environment value when set, else the declared default in the
    environment's convention (the tuner's default candidate)."""
    k = REGISTRY[name]
    v = raw(name)
    if v is not None and v.strip():
        return v.strip()
    if k.type == "bool":
        return "1" if k.default else "0"
    return "" if k.default is None else str(k.default)


def raw(name: str, default: Optional[str] = None) -> Optional[str]:
    """The raw string of a registered knob: the overlay entry when one is
    installed, else the environment (``default`` when unset). An
    unregistered name raises, so every read is declared here."""
    if name not in REGISTRY:
        raise KeyError(f"knob {name!r} is not registered in heat_tpu_torch._knobs")
    if _OVERRIDES:
        with _OVERRIDE_LOCK:
            v = _OVERRIDES.get(name)
        if v is not None:
            return v
    return os.environ.get(name, default)


def get(name: str):
    """The typed value of a registered knob, read now: the default when
    the variable is unset, empty or malformed."""
    k = REGISTRY[name]
    s = (raw(name) or "").strip()
    if not s:
        return k.default
    if k.type == "bool":
        low = s.lower()
        return (low not in FALSY) if k.default else (low in TRUTHY)
    if k.type == "int":
        try:
            return int(s)
        except ValueError:
            return k.default
    if k.type == "float":
        try:
            return float(s)
        except ValueError:
            return k.default
    if k.type == "enum":
        low = s.lower()
        return low if low in k.choices else k.default
    return s  # str / bytes / spec: the owner parses further


# -- documentation ---------------------------------------------------------------


def _default_str(k: Knob) -> str:
    if k.default is None:
        return "*(unset)*"
    if k.type == "bool":
        return "on" if k.default else "off"
    return f"`{k.default}`"


def _tunable_str(k: Knob) -> str:
    t = k.tunable
    if t is None:
        return "—"
    vals = ", ".join(t.values)
    if t.kind == "lossy":
        return f"lossy (exact: `{t.exact_value}`): `{vals}`"
    return f"{t.kind}: `{vals}`"


def markdown_table() -> str:
    """The knob catalog as markdown: the JAX package's table of runtime
    knobs, its layout (the *Tunable* column is the autotuner's search
    space). Every knob of the port is one the package reads itself."""
    out = ["### Runtime knobs\n", "| Knob | Type | Default | Tunable | Description |",
           "|---|---|---|---|---|"]
    for k in sorted(REGISTRY.values(), key=lambda k: k.name):
        typ = " \\| ".join(k.choices) if k.choices else k.type
        doc = " ".join(k.doc.split())
        out.append(f"| `{k.name}` | {typ} | {_default_str(k)} | {_tunable_str(k)} | {doc} |")
    return "\n".join(out) + "\n"
