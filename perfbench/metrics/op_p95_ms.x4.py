"""The 95th percentile of per-op times from CUDA events recorded between ops on rank 0's stream (no
host sync)."""

from perfbench.metrics._common import p95


def read(rec):
    v = p95(rec.get("event_op_s") or [])
    return None if v is None else 1000.0 * v
