"""Device milliseconds of NCCL kernels an op, on the rank with the most (waiting for the slowest
rank included)."""

from perfbench.metrics._common import traces


def read(rec):
    ts = traces(rec)
    if not ts or not rec["ops"] or not any(t["nccl_s"] > 0 for t in ts):
        return None
    return 1000.0 * max(t["nccl_s"] for t in ts) / rec["ops"]
