"""The registry of every ``HEAT_TPU_*`` environment knob the port reads.

Counterpart of ``heat_tpu/_knobs.py`` (its ``Knob``/``REGISTRY``/``get``
API, :64-153 there), kept as the port's own copy: the port imports nothing
of the JAX package. Only the knobs the port reads are registered, each with
the JAX entry's name, type and default where the meaning is the same.

A leaf module (stdlib only), importable from anywhere in the package.
Every read happens at call time, so a variable set after import (a test's
``monkeypatch.setenv``) takes effect at the next call::

    from heat_tpu_torch import _knobs as knobs
    knobs.get("HEAT_TPU_RING_OVERLAP")       # typed parse
    knobs.raw("HEAT_TPU_HBM_BUDGET", "")     # the raw string, for own parsers
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple, Union

__all__ = ["FALSY", "Knob", "REGISTRY", "TRUTHY", "get", "raw"]

# default-on knobs treat anything outside FALSY as on; default-off knobs
# need an explicit TRUTHY (the JAX package's conventions)
FALSY = ("0", "false", "off", "no")
TRUTHY = ("1", "true", "yes", "on")


@dataclass(frozen=True)
class Knob:
    """One declared environment knob. ``type`` is ``bool``, ``int``,
    ``float``, ``str``, ``enum`` or ``bytes`` (a byte count with K/M/G/T
    suffixes, parsed by its owner); ``default`` is the value when the
    variable is unset or malformed (None: the feature is off)."""

    name: str
    type: str
    default: Union[bool, int, float, str, None]
    doc: str
    choices: Tuple[str, ...] = field(default=())


REGISTRY: Dict[str, Knob] = {}


def _register(name: str, type: str, default, doc: str, *, choices: Tuple[str, ...] = ()) -> None:
    if name in REGISTRY:
        raise ValueError(f"knob {name!r} registered twice")
    if not name.startswith("HEAT_TPU_"):
        raise ValueError(f"knob {name!r} must be namespaced HEAT_TPU_*")
    REGISTRY[name] = Knob(name, type, default, doc, choices=choices)


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
# -- compressed and tiered collectives (core/collective_prec.py, core/topology.py)

_register(
    "HEAT_TPU_COLLECTIVE_PREC", "enum", "off",
    "Wire precision of the payload-moving collectives of the surfaces that "
    "resolve one (resplit, DataParallel, DASO, ZeroOptimizer, the cross-node "
    "tier): bf16 cast-move-upcast, int8 / blockwise max-abs quantization "
    "(core/collective_prec.py). Exact-semantics sites move exact.",
    choices=("off", "bf16", "int8", "blockwise"),
)
_register(
    "HEAT_TPU_COLLECTIVE_PREC_BLOCK", "int", 128,
    "Blockwise-quantization scale granularity in elements.",
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
)
_register(
    "HEAT_TPU_HIERARCHICAL_PREC", "str", None,
    "Wire precision of the cross-node tier of a tiered collective: off | bf16 "
    "| int8 | blockwise. Unset inherits HEAT_TPU_COLLECTIVE_PREC; the in-node "
    "tier always moves exact.",
)

# -- FSDP and pipeline training (parallel/fsdp.py, nn/fsdp.py, nn/pipeline.py)

_register(
    "HEAT_TPU_FSDP", "bool", False,
    "Full FSDP parameter sharding in nn.FSDP: parameters live as flat 1/p "
    "shards and each stage's weights are all-gathered just in time. `0` "
    "keeps the replicated DataParallel step.",
)
_register(
    "HEAT_TPU_FSDP_PREFETCH", "int", 1,
    "FSDP gather-prefetch depth: stage k's weight all-gather is issued "
    "(asynchronously) during stage k-d's compute, so at most d+1 stages' "
    "gathered weights are live. Outputs are bit-identical at every depth.",
)
_register(
    "HEAT_TPU_FSDP_PREC", "str", None,
    "Wire precision of FSDP weight gathers (and their reduce-scatters) for "
    "partition rules that pin none: off | bf16 | int8 | blockwise. Unset "
    "inherits the cross-node chain under HEAT_TPU_HIERARCHICAL=1, else `off`.",
)
_register(
    "HEAT_TPU_PIPELINE_SCHEDULE", "enum", "gpipe",
    "Pipeline-training schedule of nn.Pipeline (parallel/schedule.py "
    "tables): `gpipe` (forward wave, flush, backward wave) or `1f1b` (the "
    "same results bit for bit, a stash of min(S, M) microbatches and fewer "
    "steady-window bubble ticks).",
    choices=("gpipe", "1f1b"),
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
)
_register(
    "HEAT_TPU_RING_OVERLAP", "bool", True,
    "The rings (CholeskyQR2's Gram ring, the ring distances) issue each hop "
    "before its tile's product and skip the dead last hop; `0` restores the "
    "serial schedule. The tiles are the same either way.",
)
_register(
    "HEAT_TPU_CDIST_PREC", "enum", "bf16x3",
    "The cdist product on the card: `bf16x3` and `high` the 3xTF32 `wgmma` "
    "kernel (exact f32 products to ~2^-22), `default` one TF32 pass, "
    "`highest` the f32 FMA kernel. An unknown value warns and keeps `bf16x3`.",
    choices=("bf16x3", "default", "high", "highest"),
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
)
_register(
    "HEAT_TPU_SERVE_LADDER", "str", None,
    "Explicit comma-separated bucket ladder; unset derives powers of two up "
    "to the max batch.",
)
_register(
    "HEAT_TPU_SERVE_MAX_WAIT_MS", "float", 2.0,
    "Micro-batch gather window in milliseconds.",
)
_register(
    "HEAT_TPU_SERVE_QUEUE_MAX", "int", 1024,
    "Admission bound on pending serving requests (503-style shed beyond it).",
)
_register(
    "HEAT_TPU_SERVE_EXACT", "bool", True,
    "Batch-shape-stable serving forms (batched == solo bit for bit); `0` "
    "selects the GEMM forms (TF32 off).",
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
)
_register(
    "HEAT_TPU_SERVE_NET_RETRIES", "int", 2,
    "Router sibling-retry cap after a 503 shed or a refused connection.",
)
_register(
    "HEAT_TPU_AUTOSCALE_SPAWN_RETRIES", "int", 2,
    "Extra attempts of ReplicaPool.spawn() after a replica dies during "
    "warm-up (each failure reaped, with exponential backoff).",
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


def raw(name: str, default: Optional[str] = None) -> Optional[str]:
    """The raw environment string of a registered knob (``default`` when
    unset). An unregistered name raises, so every read is declared here."""
    if name not in REGISTRY:
        raise KeyError(f"knob {name!r} is not registered in heat_tpu_torch._knobs")
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
    return s  # str / bytes: the owner parses further
