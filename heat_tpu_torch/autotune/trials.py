"""Measured trials (counterpart of ``heat_tpu/autotune/trials.py``):
timed workload calls plus the digest and error validators.

Timing protocol: per candidate config, ``warmup`` untimed calls (the
first call builds: kernels load, registry programs capture), then ``k``
timed calls. Each call's output is read (a deferred fused result runs at
its first read, so reading ``larray`` brings its work inside the window)
and, when the card is in use, ``torch.cuda.synchronize()`` ends the sample
before the clock stops. The per-config statistic is the **median of k
after MAD outlier rejection**: a GC pause or a noisy neighbour
disqualifies a sample, not a config.

Validation: outputs are flattened to leaves (tensors, DNDarrays, numpy
arrays and scalars, through tuples, lists and dicts); :func:`digest` is
the bit-identity oracle (sha256 over each leaf's bytes, with its dtype and
shape: a bfloat16 leaf is hashed as its bits, never cast), and
:func:`max_rel_err` the amax-normalized error the budget bounds.
"""

from __future__ import annotations

import hashlib
import statistics
import time
from typing import Any, Callable, List, Tuple

import numpy as np
import torch

__all__ = [
    "measure",
    "robust_median",
    "digest",
    "max_rel_err",
]

# MAD z-score beyond which a sample is an outlier (the conventional
# 1.4826 factor makes MAD a consistent sigma estimator for normal noise).
_MAD_SIGMA = 1.4826
_OUTLIER_Z = 3.5


def robust_median(samples: List[float]) -> float:
    """Median after MAD outlier rejection; degenerate spreads (MAD 0)
    fall back to the plain median."""
    if not samples:
        raise ValueError("no samples")
    med = statistics.median(samples)
    mad = statistics.median([abs(s - med) for s in samples])
    if mad <= 0.0:
        return med
    kept = [
        s for s in samples
        if abs(s - med) / (_MAD_SIGMA * mad) <= _OUTLIER_Z
    ]
    return statistics.median(kept or samples)


def _flatten(out: Any) -> List[Any]:
    """The leaves of ``out`` in a fixed order; a DNDarray is its local
    tensor (reading it runs any deferred work)."""
    if isinstance(out, (tuple, list)):
        return [leaf for item in out for leaf in _flatten(item)]
    if isinstance(out, dict):
        return [leaf for k in sorted(out, key=repr) for leaf in _flatten(out[k])]
    if out is None:
        return []
    larray = getattr(out, "larray", None)
    if isinstance(larray, torch.Tensor):
        return [larray]
    return [out]


def _settle(out: Any) -> Any:
    """Read every leaf of ``out`` and wait for the card: the end of one
    timed sample."""
    leaves = _flatten(out)
    if any(isinstance(t, torch.Tensor) and t.is_cuda for t in leaves):
        torch.cuda.synchronize()
    return out


def measure(
    workload: Callable[[], Any],
    *,
    k: int,
    warmup: int = 1,
    on_sample: Callable[[int, float], None] = None,
) -> Tuple[List[float], Any]:
    """Run ``workload`` ``warmup + k`` times; returns ``(samples, out)``
    where ``out`` is the last call's (settled) output: the value the
    validators judge. ``on_sample(trial_index, seconds)`` fires per timed
    trial (the tuner's telemetry hook)."""
    out = None
    for _ in range(max(0, warmup)):
        out = _settle(workload())
    samples: List[float] = []
    for i in range(max(1, k)):
        t0 = time.perf_counter()
        out = _settle(workload())
        dt = time.perf_counter() - t0
        samples.append(dt)
        if on_sample is not None:
            on_sample(i, dt)
    return samples, out


def _host(leaf: Any) -> Tuple[str, tuple, bytes]:
    """``(dtype name, shape, raw bytes)`` of one leaf, exact to the bit."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        shape = tuple(t.shape)
        # a byte view: exact for every type, numpy's or not (bfloat16, fp8)
        raw = t.reshape(-1).contiguous().cpu().view(torch.uint8).numpy().tobytes()
        return str(t.dtype), shape, raw
    a = np.asarray(leaf)
    return a.dtype.str, a.shape, np.ascontiguousarray(a).tobytes()


def _wide(leaf: Any, device=None) -> torch.Tensor:
    """A leaf as a float64 (complex128) tensor, where it lies or on ``device``."""
    t = leaf.detach() if isinstance(leaf, torch.Tensor) else torch.as_tensor(np.asarray(leaf))
    t = t.to(device) if device is not None else t
    return t.to(torch.complex128 if t.is_complex() else torch.float64)


def digest(out: Any) -> str:
    """Bit-identity digest of an output (dtype and shape included: a
    float64 zero and a float32 zero must not collide)."""
    h = hashlib.sha256()
    for leaf in _flatten(out):
        dtype, shape, raw = _host(leaf)
        h.update(str((dtype, shape)).encode())
        h.update(raw)
    return h.hexdigest()


def max_rel_err(out: Any, ref: Any) -> float:
    """Max over leaves of ``max|out - ref| / max|ref|`` (amax-normalized;
    an all-zero reference leaf normalizes by 1). Structure or shape
    mismatches are infinite error: a candidate that changes the output
    SHAPE can never pass a numeric budget."""
    a_leaves, b_leaves = _flatten(out), _flatten(ref)
    if len(a_leaves) != len(b_leaves):
        return float("inf")
    worst = 0.0
    for a, b in zip(a_leaves, b_leaves):
        af = _wide(a)  # where it lies: a card's outputs are not copied to the host
        bf = _wide(b, af.device)
        if af.shape != bf.shape:
            return float("inf")
        if af.numel() == 0:
            continue
        denom = float(bf.abs().max()) or 1.0
        err = float((af - bf).abs().max()) / denom
        if not np.isfinite(err):
            return float("inf")
        worst = max(worst, err)
    return worst
