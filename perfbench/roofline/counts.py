"""Operations and bytes of the benchmark's ops, counted from their shapes.

Each input byte is read once and each output byte written once, whatever a
kernel reads again; the work is what these inputs need, at f32.
"""

import json
from pathlib import Path
from typing import Dict, Optional

PEAKS = Path(__file__).resolve().parent / "peaks.json"


def peaks(card: str) -> Optional[Dict[str, float]]:
    """The published peaks of ``card`` (``torch.cuda.get_device_name()``),
    or None for a card the table lacks."""
    return json.loads(PEAKS.read_text())["cards"].get(card)


def least_seconds(flops: float, nbytes: float, card_peaks: Dict[str, float]) -> float:
    """The larger of f32 operations over the f32 rate and bytes over the
    memory bandwidth."""
    return max(flops / card_peaks["f32_flops_per_s"], nbytes / card_peaks["hbm_bytes_per_s"])


def kmeans_fit(n: int, d: int, k: int, passes: int) -> Dict[str, float]:
    """A fit of ``passes`` Lloyd passes over (n, d) f32 rows and k centers,
    then the labels of the final centers. Each pass and the labelling read
    the rows once (they are far larger than the card's 50 MB L2) and score
    them against every center (2 n k d operations); the labels (int64) are
    written once."""
    reads = passes + 1
    return {"flops": 2.0 * n * k * d * reads, "bytes": 4.0 * n * d * reads + 8.0 * n}


def cdist(m: int, n: int, k: int) -> Dict[str, float]:
    """(m, n) f32 distances between m and n rows of k features: both inputs
    read once, the output written once, 2 m n k operations for the product."""
    return {"flops": 2.0 * m * n * k, "bytes": 4.0 * (m + n) * k + 4.0 * m * n}
