"""What several readers share."""

import statistics
from typing import List, Optional


def p95(values: List[float]) -> Optional[float]:
    """The 95th percentile (inclusive method) of at least two values."""
    if len(values) < 2:
        return None
    return statistics.quantiles(values, n=20, method="inclusive")[18]


def traces(rec) -> list:
    """Every rank's trace summary, or [] in a run without a trace."""
    return [r["trace"] for r in rec["ranks"] if r.get("trace")]
