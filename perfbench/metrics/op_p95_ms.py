"""The 95th percentile of the ops' walls, each ended by a synchronise, over every op in the
window."""

from perfbench.metrics._common import p95


def read(rec):
    v = p95(rec.get("op_walls") or [])
    return None if v is None else 1000.0 * v
