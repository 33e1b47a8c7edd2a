"""Statistical functions (counterpart of ``heat_tpu/core/statistics.py``).

``mean`` and ``var`` route the f32 axis-0 reduction of a 2-D array through
the moments kernel exactly where the JAX package routes them through its
Pallas kernel (``statistics.py:616-628`` and ``:912-924`` there): one read
of X gives mean and M2, and across ranks the closed-form merge takes two
allreduces; ``chunk_moments`` returns that carry from one launch. Every
other case takes the plain reduction path. A kernel failure raises; nothing
falls back. A pending fused chain in front of the kernel is grafted into
the kernel's program (site ``fusion_moments``, the JAX package's
``_pallas_moments_fused``): the chain and one K2 launch run as one cached
program, once for ``mean`` and once for ``var``, and the chain's value is
kept, so a second call reads it.

Across ranks: ``argmax``/``argmin`` gather each rank's extreme and its
global index and keep numpy's rule, the lowest global index wins a tie;
``bincount`` and ``histogram`` count each rank's chunk and allreduce the
counts; the nan-reductions allreduce their sums, extremes and counts.
``percentile`` and ``median`` along the split axis sort with the
distributed sort of ``manipulations`` and fetch only the order-statistic
rows from their owners; elsewhere they compute on the whole array as the
JAX package's ``jnp.percentile`` does (its arithmetic and types too).
"""

from __future__ import annotations

import builtins
from typing import Optional, Tuple

import numpy as np
import torch

from . import arithmetics, exponential, types
from ._operations import _WIDTH, binary_op, into, order_key, reduce_op, tensor_operands
from .dndarray import DNDarray
from .stride_tricks import sanitize_axis

__all__ = [
    "argmax",
    "argmin",
    "average",
    "bincount",
    "chunk_moments",
    "cov",
    "histc",
    "histogram",
    "kurtosis",
    "max",
    "maximum",
    "mean",
    "median",
    "min",
    "minimum",
    "nanmax",
    "nanmean",
    "nanmin",
    "nanstd",
    "nanvar",
    "percentile",
    "skew",
    "std",
    "var",
]


def _neutral_extreme(x: DNDarray, is_max: bool):
    if issubclass(x.dtype, types.integer):
        info = types.iinfo(x.dtype)
        return info.min if is_max else info.max
    if issubclass(x.dtype, types.bool):
        return not is_max
    return -float("inf") if is_max else float("inf")


def _reduced_count(x: DNDarray, axis) -> int:
    if axis is None:
        return x.size
    axes = (axis,) if isinstance(axis, builtins.int) else tuple(axis)
    n = 1
    for a in axes:
        n *= x.shape[a]
    return n


def _sharded(x: DNDarray) -> bool:
    return x.split is not None and x.comm.size > 1


def _replicated(t, like: DNDarray) -> DNDarray:
    return DNDarray(t, tuple(t.shape), types.canonical_heat_type(t.dtype), None,
                    like.device, like.comm, True)


# ---------------------------------------------------------------- arg-extremes


def _combine_extremes(comm, val: torch.Tensor, idx: torch.Tensor, is_max: bool):
    """The global extreme of every rank's ``(val, idx)`` in rank order: a
    later rank wins only when strictly better (or the first NaN), so the
    lowest global index wins a tie, as in numpy."""
    vals = comm.allgather(val.unsqueeze(0).contiguous(), 0, comm.size)
    idxs = comm.allgather(idx.unsqueeze(0).contiguous(), 0, comm.size)
    best_v, best_i = vals[0], idxs[0]
    for r in range(1, comm.size):
        v = vals[r]
        better = v > best_v if is_max else v < best_v
        if v.is_floating_point():
            better = better | (torch.isnan(v) & ~torch.isnan(best_v))
        best_v = torch.where(better, v, best_v)
        best_i = torch.where(better, idxs[r], best_i)
    return best_i


def _arg_reduce(x: DNDarray, axis, is_max: bool, out=None, keepdims: bool = False) -> DNDarray:
    fn = torch.argmax if is_max else torch.argmin
    buf = x.larray
    if buf.dtype == torch.bool:
        buf = buf.to(torch.uint8)
    neutral = _neutral_extreme(x, is_max)
    if buf.dtype in _WIDTH:  # the wide unsigned types compare on their order keys
        neutral = order_key(torch.tensor(neutral, dtype=buf.dtype)).item()
        buf = order_key(buf)
    comm = x.comm
    offset = comm.chunk(x.shape, x.split)[0] if x.split is not None else 0
    if axis is None:
        flat = buf.reshape(-1)
        if flat.numel():
            li = fn(flat)
            val = flat[li]
            coords = list(np.unravel_index(int(li), buf.shape)) if buf.ndim else []
            if x.split is not None:
                coords[x.split] += offset
            gi = int(np.ravel_multi_index(coords, x.shape)) if x.ndim else 0
        else:
            val, gi = torch.tensor(neutral, dtype=buf.dtype, device=buf.device), 0
        gidx = torch.tensor(gi, dtype=torch.int64, device=buf.device)
        if _sharded(x):
            gidx = _combine_extremes(comm, val.reshape(()), gidx, is_max)
        gshape = (1,) * x.ndim if keepdims else ()
        return into(DNDarray(gidx.reshape(gshape), gshape, types.int64, None, x.device, comm,
                             True), out)
    axis = sanitize_axis(x.shape, axis)
    if buf.shape[axis]:
        idx = fn(buf, dim=axis, keepdim=True)
        val = buf.gather(axis, idx)
    else:
        shape = tuple(1 if d == axis else s for d, s in enumerate(buf.shape))
        idx = torch.zeros(shape, dtype=torch.int64, device=buf.device)
        val = torch.full(shape, neutral, dtype=buf.dtype, device=buf.device)
    split = x.split
    if split == axis and comm.size > 1:
        idx = _combine_extremes(comm, val, idx + offset, is_max)
    if not keepdims:
        idx = idx.squeeze(axis)
    if split is None or split == axis:
        out_split = None
    else:
        out_split = split if keepdims else split - (1 if axis < split else 0)
    if keepdims:
        gshape = tuple(1 if d == axis else s for d, s in enumerate(x.shape))
    else:
        gshape = tuple(s for d, s in enumerate(x.shape) if d != axis)
    res = DNDarray(idx.to(torch.int64).contiguous(), gshape, types.int64, out_split, x.device,
                   comm, True)
    return into(res, out)


def argmax(x: DNDarray, axis=None, out=None, keepdims: bool = False) -> DNDarray:
    """The index of the maximum (the first one), flat over the global
    array without ``axis``."""
    return _arg_reduce(x, axis, True, out, keepdims)


def argmin(x: DNDarray, axis=None, out=None, keepdims: bool = False) -> DNDarray:
    """The index of the minimum (the first one), flat over the global
    array without ``axis``."""
    return _arg_reduce(x, axis, False, out, keepdims)


# ------------------------------------------------------------ means and moments


def _column_moments(x: DNDarray):
    """(mean, M2) of a 2-D f32 array over axis 0 from the moments kernel,
    merged across ranks; None when the kernel's gate does not admit ``x``."""
    from .cuda_moments import pallas_moments_applicable, sharded_merge

    if not (x.ndim == 2 and x.split in (None, 0)):
        return None
    if not pallas_moments_applicable(x.comm.size, x.split, x.ndim, 0, x.shape[1],
                                     x.dtype.torch_type()):
        return None
    from . import fusion

    node = fusion.absorbing(x)
    if node is not None:
        # the chain and the kernel as one program
        mu, m2 = fusion.absorb(node, "fusion_moments", ("moments",), _kernel_moments,
                               want="moments")
    else:
        mu, m2 = _kernel_moments(x.larray)
    if x.comm.size > 1 and x.split == 0:
        mu, m2 = sharded_merge(x.comm, x.lshape[0], mu, m2, x.shape[0])
    return mu, m2


def _kernel_moments(buf: torch.Tensor):
    """One K2 launch on this rank's contiguous chunk."""
    from .cuda_moments import column_moments

    return column_moments(buf.contiguous())


def chunk_moments(x: DNDarray) -> Tuple[int, torch.Tensor, torch.Tensor]:
    """The column-moment carry ``(n, mean (d,), M2 (d,))`` over the rows of a
    2-D array, the same on every rank: one moments-kernel launch (and the
    two-allreduce merge across ranks) inside the kernel's gate, the plain
    two-pass version outside it (exact types in float64)."""
    if not isinstance(x, DNDarray):
        raise TypeError(f"chunk_moments needs a DNDarray, got {type(x)}")
    if x.ndim != 2:
        raise ValueError("chunk_moments needs a 2-D (rows, features) chunk")
    n = x.shape[0]
    if n == 0:
        raise ValueError("chunk_moments: empty chunk (0 rows)")
    from . import program_cache

    mu, m2 = program_cache.cached_program(
        "streaming.moments", (x.shape, x.dtype, x.split), lambda: _chunk_moments_program,
        comm=x.comm, inline=True)(x)
    return n, mu, m2


def _chunk_moments_program(x: DNDarray) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(mean, M2)`` of :func:`chunk_moments` (the registry program of site
    ``streaming.moments``)."""
    from .cuda_moments import column_moments_plain, sharded_merge

    n = x.shape[0]
    moments = _column_moments(x)
    if moments is not None:
        return moments
    buf = x.larray
    if not (buf.is_floating_point() or buf.is_complex()):
        buf = buf.to(torch.float64)  # the JAX package's sums of exact types divide to float64
    mu, m2 = column_moments_plain(buf)
    if x.comm.size > 1 and x.split == 0:
        mu, m2 = sharded_merge(x.comm, buf.shape[0], mu, m2, n)
    elif x.comm.size > 1 and x.split == 1:
        mu = x.comm.allgather(mu, 0, x.shape[1])
        m2 = x.comm.allgather(m2, 0, x.shape[1])
    return mu, m2


def max(x: DNDarray, axis=None, out=None, keepdims: bool = False) -> DNDarray:
    """Maximum along axis (local max + one allreduce)."""
    return reduce_op("max", x, axis, neutral=_neutral_extreme(x, True), out=out, keepdims=keepdims)


def min(x: DNDarray, axis=None, out=None, keepdims: bool = False) -> DNDarray:
    """Minimum along axis (local min + one allreduce)."""
    return reduce_op("min", x, axis, neutral=_neutral_extreme(x, False), out=out, keepdims=keepdims)


def maximum(x1, x2, out=None) -> DNDarray:
    """Elementwise maximum (NaN propagates)."""
    return binary_op(tensor_operands(torch.maximum), x1, x2, out, unsigned="order")


def minimum(x1, x2, out=None) -> DNDarray:
    """Elementwise minimum (NaN propagates)."""
    return binary_op(tensor_operands(torch.minimum), x1, x2, out, unsigned="order")


def mean(x: DNDarray, axis=None, keepdims_internal: bool = False, keepdims: bool = False) -> DNDarray:
    """Arithmetic mean. The f32 axis-0 2-D case goes through the moments
    kernel, as :func:`var` does."""
    if axis == 0 and not keepdims and not keepdims_internal and isinstance(x, DNDarray):
        moments = _column_moments(x)
        if moments is not None:
            return _replicated(moments[0], x)
    keep = keepdims or keepdims_internal
    s = arithmetics.sum(x, axis, keepdims=keep)
    n = _reduced_count(x, sanitize_axis(x.shape, axis) if axis is not None else None)
    return arithmetics.div(s, n)


def var(x: DNDarray, axis=None, ddof: int = 0, keepdims: bool = False) -> DNDarray:
    """Variance. The f32 axis-0 2-D case is ``M2 / (n - ddof)`` from the
    moments kernel; elsewhere two passes."""
    if not isinstance(ddof, builtins.int):
        raise ValueError(f"ddof must be integer, is {type(ddof)}")
    if ddof not in (0, 1):
        raise ValueError("Heat currently supports ddof of 0 or 1 only")
    if axis == 0 and not keepdims and isinstance(x, DNDarray):
        moments = _column_moments(x)
        if moments is not None:
            return _replicated(moments[1] / (x.shape[0] - ddof), x)
    mu = mean(x, axis, keepdims_internal=True)
    d = arithmetics.sub(x, mu)
    sq = arithmetics.mul(d, d)
    s = arithmetics.sum(sq, axis, keepdims=keepdims)
    n = _reduced_count(x, sanitize_axis(x.shape, axis) if axis is not None else None)
    return arithmetics.div(s, n - ddof)


def std(x: DNDarray, axis=None, ddof: int = 0, keepdims: bool = False) -> DNDarray:
    """Standard deviation."""
    return exponential.sqrt(var(x, axis, ddof=ddof, keepdims=keepdims))


def average(x: DNDarray, axis=None, weights: Optional[DNDarray] = None, returned: bool = False):
    """Weighted average; with ``returned`` also the sum of the weights, in
    the average's shape. One-dimensional weights run along ``axis``."""
    from . import factories

    if weights is None:
        avg = mean(x, axis)
        n = _reduced_count(x, sanitize_axis(x.shape, axis) if axis is not None else None)
        wsum = factories.full(avg.shape if avg.ndim else (), float(n), dtype=types.float32,
                              split=avg.split if avg.ndim else None, device=x.device,
                              comm=x.comm)
        return (avg, wsum) if returned else avg
    if weights.ndim == 1 and axis is not None and isinstance(axis, builtins.int):
        axis = sanitize_axis(x.shape, axis)
        if weights.shape[0] != x.shape[axis]:
            raise ValueError("Length of weights not compatible with specified axis")
        shape = [1] * x.ndim
        shape[axis] = weights.shape[0]
        # replicated along the axis: binary_op cuts it to x's chunk
        w = _replicated(weights._global().reshape(shape), x)
    elif weights.shape == x.shape:
        w = weights
    else:
        raise TypeError("Axis must be specified when shapes of x and weights differ")
    num = arithmetics.sum(arithmetics.mul(x, w), axis)
    den = arithmetics.sum(w, axis)
    avg = arithmetics.div(num, den)
    if returned:
        if tuple(den.shape) != tuple(avg.shape):
            den = arithmetics.mul(den, factories.ones(avg.shape, dtype=den.dtype, split=avg.split,
                                                      device=x.device, comm=x.comm))
        return avg, den
    return avg


def _central_moment(x: DNDarray, axis, k: int) -> DNDarray:
    """E[(x - mean)^k] in two passes."""
    mu = mean(x, axis, keepdims_internal=True)
    return mean(arithmetics.pow(arithmetics.sub(x, mu), k), axis)


def kurtosis(x: DNDarray, axis=None, fisher: bool = True, bias: bool = True) -> DNDarray:
    """Kurtosis, Fisher's (excess) by default; ``bias=False`` applies the
    standard unbiased correction."""
    m2 = _central_moment(x, axis, 2)
    m4 = _central_moment(x, axis, 4)
    res = arithmetics.div(m4, arithmetics.pow(m2, 2))
    if not bias:
        n = float(_reduced_count(x, sanitize_axis(x.shape, axis) if axis is not None else None))
        g2 = res - 3.0
        res = ((n - 1) / ((n - 2) * (n - 3))) * ((n + 1) * g2 + 6.0) + 3.0
    if fisher:
        res = arithmetics.sub(res, 3.0)
    return res


def skew(x: DNDarray, axis=None, unbiased: bool = True) -> DNDarray:
    """Skewness, with the ``sqrt(n (n - 1)) / (n - 2)`` correction when
    ``unbiased`` and n > 2."""
    m2 = _central_moment(x, axis, 2)
    m3 = _central_moment(x, axis, 3)
    res = arithmetics.div(m3, arithmetics.pow(m2, 1.5))
    if unbiased:
        n = float(_reduced_count(x, sanitize_axis(x.shape, axis) if axis is not None else None))
        if n > 2:
            res = arithmetics.mul(res, float(np.sqrt(n * (n - 1)) / (n - 2)))
    return res


def cov(m: DNDarray, y: Optional[DNDarray] = None, rowvar: bool = True, bias: bool = False,
        ddof: Optional[int] = None) -> DNDarray:
    """The covariance matrix of the variables (rows when ``rowvar``) over
    the observations: centered product over ``n - ddof`` (ddof 1, or 0 with
    ``bias``), through the distributed ``matmul``."""
    from .linalg import matmul, transpose
    from .manipulations import concatenate

    if ddof is not None and not isinstance(ddof, builtins.int):
        raise ValueError("ddof must be integer")
    if m.ndim > 2:
        raise ValueError("m has more than 2 dimensions")

    def as_rows(a: DNDarray) -> DNDarray:
        if a.ndim == 1:
            a = _replicated(a._global()[None, :], a)
        if not rowvar and a.shape[0] != 1:
            a = transpose(a)
        return a

    x = as_rows(m)
    if y is not None:
        x = concatenate([x, as_rows(y)], axis=0)
    if ddof is None:
        ddof = 0 if bias else 1
    n = x.shape[1]
    mu = mean(x, axis=1)
    centered = arithmetics.sub(x, _replicated(mu._global()[:, None], x))
    return arithmetics.div(matmul(centered, transpose(centered)), n - ddof)


# ------------------------------------------------------------ the nan-family


def _nan_parts(x: DNDarray, axis, keepdims: bool, fill, reduce):
    """``(reduce of x with NaN as fill, count of non-NaN)`` over ``axis``,
    each the DNDarray of a ``reduce_op``."""
    nan = torch.isnan(x.larray)
    filled = DNDarray(torch.where(nan, fill, x.larray), x.shape, x.dtype, x.split, x.device,
                      x.comm, True)
    count = DNDarray((~nan).to(torch.int64), x.shape, types.int64, x.split, x.device, x.comm,
                     True)
    return (reduce_op(reduce, filled, axis, neutral=fill, keepdims=keepdims),
            reduce_op("sum", count, axis, neutral=0, keepdims=keepdims))


def _with_nan_where_empty(value: DNDarray, count: DNDarray, out) -> DNDarray:
    data = torch.where(count.larray == 0, float("nan"), value.larray).to(value.larray.dtype)
    return into(DNDarray(data, value.shape, value.dtype, value.split, value.device, value.comm,
                         True), out)


def nanmax(x: DNDarray, axis=None, out=None, keepdims: bool = False) -> DNDarray:
    """Maximum ignoring NaN; NaN where a lane holds only NaN. Exact types
    take :func:`max`."""
    if not x.dtype.torch_type().is_floating_point:
        return max(x, axis, out=out, keepdims=keepdims)
    value, count = _nan_parts(x, axis, keepdims, -float("inf"), "max")
    return _with_nan_where_empty(value, count, out)


def nanmin(x: DNDarray, axis=None, out=None, keepdims: bool = False) -> DNDarray:
    """Minimum ignoring NaN (see :func:`nanmax`)."""
    if not x.dtype.torch_type().is_floating_point:
        return min(x, axis, out=out, keepdims=keepdims)
    value, count = _nan_parts(x, axis, keepdims, float("inf"), "min")
    return _with_nan_where_empty(value, count, out)


def nanmean(x: DNDarray, axis=None, out=None, keepdims: bool = False) -> DNDarray:
    """Mean ignoring NaN: the sum of the other values over their count."""
    if not x.dtype.torch_type().is_floating_point:
        return into(mean(x, axis, keepdims=keepdims), out)
    total, count = _nan_parts(x, axis, keepdims, 0.0, "sum")
    res = DNDarray(total.larray / count.larray.to(total.larray.dtype), total.shape, total.dtype,
                   total.split, x.device, x.comm, True)
    return into(res, out)


def nanvar(x: DNDarray, axis=None, ddof: int = 0, out=None, keepdims: bool = False) -> DNDarray:
    """Variance ignoring NaN, two passes: the NaN-free mean, then the sum of
    squared deviations over ``count - ddof`` (NaN where that is not
    positive)."""
    if not x.dtype.torch_type().is_floating_point:
        return into(var(x, axis, ddof=ddof, keepdims=keepdims), out)
    mu = nanmean(x, axis, keepdims=True)
    d = arithmetics.sub(x, mu)
    total, count = _nan_parts(arithmetics.mul(d, d), axis, keepdims, 0.0, "sum")
    dof = (count.larray - builtins.int(ddof)).to(total.larray.dtype)
    data = torch.where(dof > 0, total.larray / dof, float("nan")).to(total.larray.dtype)
    res = DNDarray(data, total.shape, total.dtype, total.split, x.device, x.comm, True)
    return into(res, out)


def nanstd(x: DNDarray, axis=None, ddof: int = 0, out=None, keepdims: bool = False) -> DNDarray:
    """Standard deviation ignoring NaN."""
    if not x.dtype.torch_type().is_floating_point:
        return into(std(x, axis, ddof=ddof, keepdims=keepdims), out)
    return into(exponential.sqrt(nanvar(x, axis, ddof=ddof, keepdims=keepdims)), out)


# ---------------------------------------------------------------- histograms


def _global_minmax(x: DNDarray):
    """(min, max) of the global values as python numbers; (nan, nan) when
    any value is NaN."""
    buf = x.larray
    if buf.dtype == torch.bool:
        buf = buf.to(torch.uint8)
    if buf.dtype in _WIDTH:
        return builtins.int(min(x).larray.item()), builtins.int(max(x).larray.item())
    if buf.numel():
        lo, hi = buf.amin().reshape(1), buf.amax().reshape(1)
        has_nan = torch.isnan(buf).any().reshape(1).to(torch.uint8) if buf.is_floating_point() \
            else torch.zeros(1, dtype=torch.uint8, device=buf.device)
    else:
        lo = torch.full((1,), _neutral_extreme(x, False), dtype=buf.dtype, device=buf.device)
        hi = torch.full((1,), _neutral_extreme(x, True), dtype=buf.dtype, device=buf.device)
        has_nan = torch.zeros(1, dtype=torch.uint8, device=buf.device)
    if _sharded(x):
        lo, hi = x.comm.allreduce(lo, "min"), x.comm.allreduce(hi, "max")
        has_nan = x.comm.allreduce(has_nan, "max")
    if int(has_nan):
        return float("nan"), float("nan")
    return lo.item(), hi.item()


def _sanitize_range(lo: float, hi: float):
    """numpy's histogram range rules: finite, ordered, degenerate widened."""
    lo, hi = float(lo), float(hi)
    if not (np.isfinite(lo) and np.isfinite(hi)):
        raise ValueError(f"supplied range of [{lo}, {hi}] is not finite")
    if lo > hi:
        raise ValueError("max must be larger than min in range parameter")
    if lo == hi:
        return lo - 0.5, hi + 0.5
    return lo, hi


def _local_weights(x: DNDarray, weights) -> Optional[torch.Tensor]:
    """``weights`` (x's shape) as this rank's chunk of x's layout."""
    if weights is None:
        return None
    if isinstance(weights, DNDarray):
        if tuple(weights.shape) != tuple(x.shape):
            raise ValueError("weights must have the same shape as the input")
        return weights.resplit(x.split).larray if weights.split != x.split else weights.larray
    w = np.asarray(weights)
    if tuple(w.shape) != tuple(x.shape):
        raise ValueError("weights must have the same shape as the input")
    whole = torch.as_tensor(w, device=x.larray.device)
    return whole[x.comm.chunk(x.shape, x.split)[2]] if x.split is not None else whole


def _hist_counts(x: DNDarray, edges: np.ndarray, weights) -> torch.Tensor:
    """Float64 counts (or summed weights) of x's values in the bins of
    ``edges`` (the last bin closed, values outside dropped), binned in
    float64, this rank's chunk counted and the counts allreduced."""
    dev = x.larray.device
    vals = x.larray.reshape(-1).to(torch.float64)
    e = torch.as_tensor(edges, dtype=torch.float64, device=dev)
    w = _local_weights(x, weights)
    idx = torch.searchsorted(e, vals, right=True)
    idx = torch.where(vals == e[-1], len(edges) - 1, idx)
    if w is None:
        counts = torch.bincount(idx, minlength=len(edges) + 1).to(torch.float64)
    else:
        counts = torch.zeros(len(edges) + 1, dtype=torch.float64, device=dev).index_add_(
            0, idx, w.reshape(-1).to(torch.float64))
    counts = counts[1:len(edges)].contiguous()
    return x.comm.allreduce(counts) if _sharded(x) else counts


def histc(input: DNDarray, bins: int = 100, min: float = 0.0, max: float = 0.0, out=None) -> DNDarray:
    """Histogram with ``bins`` equal bins in [min, max] (the data's range
    when both are 0), in the input's type; values outside are ignored."""
    lo, hi = float(min), float(max)
    if lo == 0.0 and hi == 0.0 and input.size > 0:
        lo, hi = _global_minmax(input)
    lo, hi = _sanitize_range(lo, hi)
    edges = np.linspace(lo, hi, builtins.int(bins) + 1)
    res = _replicated(_hist_counts(input, edges, None).to(input.dtype.torch_type()), input)
    if out is not None:
        return into(res, out)
    return res


def histogram(a: DNDarray, bins: int = 10, range=None, normed=None, weights=None, density=None):
    """numpy's histogram: ``(counts, edges)``, both replicated. Counts are
    int64 for a split array without weights and float64 otherwise, as in
    the JAX package on a mesh of devices."""
    if hasattr(bins, "__len__"):
        edges = np.asarray(bins, dtype=np.float64)
    else:
        if range is not None:
            lo, hi = float(range[0]), float(range[1])
        elif a.size:
            lo, hi = _global_minmax(a)
        else:
            lo, hi = 0.0, 1.0
        lo, hi = _sanitize_range(lo, hi)
        edges = np.linspace(lo, hi, builtins.int(bins) + 1)
    hist = _hist_counts(a, edges, weights)
    if weights is None and a.split is not None:
        hist = hist.to(torch.int64)
    if density:
        widths = torch.as_tensor(np.diff(edges), device=hist.device)
        hist = hist / widths / hist.sum()
    return _replicated(hist, a), _replicated(torch.as_tensor(edges, device=hist.device), a)


def bincount(x: DNDarray, weights: Optional[DNDarray] = None, minlength: int = 0) -> DNDarray:
    """Occurrences of each non-negative integer (or their summed weights),
    replicated: each rank counts its chunk and one allreduce adds them.
    Counts are int64; weights sum in float64 for a split array and in their
    own type otherwise, as in the JAX package on a mesh of devices."""
    if x.ndim != 1:
        raise ValueError("object too deep for desired array")
    nbins = builtins.int(minlength)
    if x.size > 0:
        mn, mx = (builtins.int(v) for v in _global_minmax(x))
        if mn < 0:
            raise ValueError("bincount: input must have no negative elements")
        nbins = builtins.max(mx + 1, nbins)
    vals = x.larray.to(torch.int64)
    w = _local_weights(x, weights)
    if w is None:
        acc, w = torch.int64, torch.ones_like(vals)
    else:
        acc = torch.float64 if x.split is not None else w.dtype
    counts = torch.zeros(nbins, dtype=acc, device=vals.device).index_add_(0, vals, w.to(acc))
    if _sharded(x):
        counts = x.comm.allreduce(counts)
    return _replicated(counts, x)


DNDarray.argmax = lambda self, axis=None, out=None, keepdims=False: argmax(self, axis, out, keepdims)
DNDarray.argmin = lambda self, axis=None, out=None, keepdims=False: argmin(self, axis, out, keepdims)
DNDarray.max = lambda self, axis=None, out=None, keepdims=False: max(self, axis, out, keepdims)
DNDarray.min = lambda self, axis=None, out=None, keepdims=False: min(self, axis, out, keepdims)
DNDarray.mean = lambda self, axis=None, keepdims=False: mean(self, axis, keepdims=keepdims)
DNDarray.std = lambda self, axis=None, ddof=0, keepdims=False: std(self, axis, ddof, keepdims)
DNDarray.var = lambda self, axis=None, ddof=0, keepdims=False: var(self, axis, ddof, keepdims)
DNDarray.average = lambda self, axis=None, weights=None, returned=False: average(
    self, axis, weights, returned)


# ------------------------------------------------------ order statistics

_PERCENTILE_METHODS = ("linear", "lower", "higher", "midpoint", "nearest")


def _positions(q_flat: np.ndarray, n: int):
    """The fractional positions of the percentiles among ``n`` sorted values
    and their floor and ceiling (float64, as the JAX package computes them)."""
    pos = q_flat / 100.0 * (n - 1)
    return pos, np.floor(pos).astype(np.int64), np.ceil(pos).astype(np.int64)


def _percentile_split_axis(x: DNDarray, q_flat: np.ndarray, method: str, ax: int) -> torch.Tensor:
    """Percentiles along the split axis (reference statistics.py:730): the
    distributed sort, then only the order-statistic rows, fetched from their
    owners to every rank, interpolated in float64. A lane with a NaN gives
    NaN. Returns ``(len(q), *rest)``."""
    from .indexing import _fetch_rows, _index_select
    from .manipulations import sort

    n = x.shape[ax]
    vals, _ = sort(x, axis=ax)
    pos, i0, i1 = _positions(q_flat, n)
    m = len(q_flat)
    picks = {"lower": i0, "higher": i1, "nearest": np.round(pos).astype(np.int64)}
    idx = picks.get(method, np.concatenate([i0, i1]))
    dev = x.larray.device
    want = torch.as_tensor(idx, device=dev)
    moved = vals.larray.movedim(ax, 0)
    if x.comm.size > 1:
        rows = _fetch_rows(moved, n, x.comm, lambda q: want)
    else:
        rows = _index_select(moved, 0, want)
    rows = rows.to(torch.float64)
    if method == "linear":
        frac = torch.as_tensor(pos - i0, device=dev).reshape((m,) + (1,) * (x.ndim - 1))
        res = rows[:m] + (rows[m:] - rows[:m]) * frac
    elif method == "midpoint":
        res = (rows[:m] + rows[m:]) / 2.0
    else:
        res = rows
    if x.dtype.torch_type().is_floating_point:
        lane = torch.isnan(x.larray).any(ax).to(torch.uint8)
        if x.comm.size > 1:
            x.comm.allreduce(lane, "max")
        res = torch.where(lane.to(torch.bool)[None], torch.nan, res)
    return res


def _percentile_whole(t: torch.Tensor, q_flat: np.ndarray, axes, method: str) -> torch.Tensor:
    """``jnp.percentile`` on a whole array, reduced over ``axes`` (all when
    None): the values in their inexact type, sorted, a lane with a NaN all
    NaN; ``linear`` in float64 rounded to that type, ``midpoint`` in it.
    ``nearest`` picks the values at the half-to-even rounded positions
    (the JAX package's own rule). Returns ``(len(q), *kept)`` in float64."""
    from ._operations import _INEXACT

    if method != "nearest":
        t = t.to(_INEXACT.get(t.dtype, t.dtype))
    nd = t.ndim
    axes = tuple(range(nd)) if axes is None else axes
    kept = [d for d in range(nd) if d not in axes]
    t = t.permute(kept + list(axes))
    t = t.reshape(t.shape[:len(kept)] + (-1,))
    n = t.shape[-1]
    nan = torch.isnan(t).any(-1, keepdim=True) if t.is_floating_point() else None
    if nan is not None and method != "nearest":
        t = torch.where(nan, torch.nan, t)
    srt = torch.sort(t, dim=-1).values if t.dtype != torch.bool else \
        torch.sort(t.to(torch.uint8), dim=-1).values.to(torch.bool)
    pos, i0, i1 = _positions(q_flat, n)
    dev = t.device
    if method == "nearest":
        res = srt[..., torch.as_tensor(np.round(pos).astype(np.int64), device=dev)]
        res = res.to(torch.float64)
        if nan is not None:
            res = torch.where(nan, torch.nan, res)
        return res.movedim(-1, 0)
    lo = srt[..., torch.as_tensor(np.clip(i0, 0, n - 1), device=dev)]
    hi = srt[..., torch.as_tensor(np.clip(i1, 0, n - 1), device=dev)]
    if method == "linear":
        hw = torch.as_tensor(pos - i0, device=dev)
        res = (lo.to(torch.float64) * (1.0 - hw) + hi.to(torch.float64) * hw).to(t.dtype)
    elif method == "lower":
        res = lo
    elif method == "higher":
        res = hi
    else:
        res = (lo + hi) * 0.5
    return res.to(torch.float64).movedim(-1, 0)


def percentile(x: DNDarray, q, axis=None, out=None, interpolation: str = "linear",
               keepdims: bool = False) -> DNDarray:
    """The ``q``-th percentiles (reference statistics.py:785), float64 and
    replicated. Along the split axis (a 1-D array, or the split axis of an
    n-D one) :func:`_percentile_split_axis`; otherwise the whole array.
    ``q`` may be a scalar or an array of any shape, whose dimensions lead
    the result's."""
    qv = np.asarray(q.numpy() if isinstance(q, DNDarray) else q, dtype=np.float64)
    if np.any(~((qv >= 0.0) & (qv <= 100.0))):
        raise ValueError("percentiles must be in the range [0, 100]")
    if interpolation not in _PERCENTILE_METHODS:
        raise ValueError("method can only be 'linear', 'lower', 'higher', 'midpoint', or "
                         "'nearest'")
    q_shape, q_flat = qv.shape, np.atleast_1d(qv).ravel()
    ax = sanitize_axis(x.shape, axis) if axis is not None else None
    axes = None if ax is None else ((ax,) if isinstance(ax, builtins.int) else tuple(ax))
    s = x.split
    if s is not None and x.shape[s] > 0 and q_flat.size > 0 and (
            (x.ndim == 1 and axes in (None, (0,))) or (x.ndim > 1 and axes == (s,))):
        res = _percentile_split_axis(x, q_flat, interpolation, s)
        reduced = (s,)
    else:
        res = _percentile_whole(x._global(), q_flat, axes, interpolation)
        reduced = tuple(range(x.ndim)) if axes is None else axes
    if keepdims:
        for d in sorted(reduced):
            res = res.unsqueeze(d + 1)
    res = res.reshape(q_shape + tuple(res.shape[1:]))
    res = _replicated(res.contiguous(), x)
    return into(res, out)


def median(x: DNDarray, axis=None, keepdims: bool = False) -> DNDarray:
    """The median, ``percentile(x, 50)``."""
    return percentile(x, 50.0, axis=axis, keepdims=keepdims)


DNDarray.median = lambda self, axis=None, keepdims=False: median(self, axis, keepdims)
