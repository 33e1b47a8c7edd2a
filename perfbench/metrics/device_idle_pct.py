"""The share of the traced window in which the card ran nothing, in percent; on several cards the
largest rank's."""

from perfbench.metrics._common import traces


def read(rec):
    ts = traces(rec)
    if not ts:
        return None
    return max(100.0 * (1.0 - t["busy_s"] / t["window_s"]) for t in ts)
