"""Device kernels an op, from the profiler, on rank 0."""

from perfbench.metrics._common import traces


def read(rec):
    ts = traces(rec)
    return ts[0]["kernels"] / rec["ops"] if ts and rec["ops"] else None
