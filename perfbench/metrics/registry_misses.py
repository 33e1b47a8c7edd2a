"""Misses of the program registry (program_cache.stats()) over the window; 0 once warm."""


def read(rec):
    return float(sum(r["registry_misses"] for r in rec["ranks"]))
