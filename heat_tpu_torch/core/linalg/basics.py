"""Linear algebra basics (counterpart of ``heat_tpu/core/linalg/basics.py``).

``matmul`` keeps the JAX package's result-split table (``basics.py:108-150``
there) for 2-D operands, vector promotions and batched N-D operands. With
per-rank chunks and no pad, each split pair runs one of two ways:

* **carried**: the result's split axis comes from a dimension that the
  product carries (rows or batch of ``a``, columns or batch of ``b``). The
  operand that owns it keeps its chunk; the other is made whole on every
  rank (``allgather`` when it is split) and cut to the same chunk where it
  spans that dimension. One local product gives this rank's chunk.
* **contraction across ranks** (``a`` split along its contraction axis, or
  ``a`` replicated and ``b`` split along its own): each rank multiplies its
  chunk of the contraction axis of both operands into a partial of the
  whole result, sliced from a replicated operand or resplit to that axis
  through ``all_to_all``; a ``reduce_scatter`` along the result's split
  axis (an ``allreduce`` when it has none) sums the partials.

Uneven tails and empty chunks (a dimension shorter than the world) need no
mask: an empty chunk contributes a zero partial.

The product is ``torch.matmul`` (cuBLAS on the card): the JAX package runs
``jnp.matmul`` outside any Pallas kernel. torch has no product of exact
types on the card (and on the CPU none of bool or the wide unsigned
types), so an exact product is summed from float64 products of 16-bit
limbs, exact in int64 modulo 2^64, and cast back with the wrap of its type
as the JAX package's product wraps; bool is the count of true pairs, > 0
(:func:`_exact_products`). Its f32 precision is the caller's
``torch.backends.cuda.matmul.allow_tf32``, read and never set, as the JAX
package reads the caller's ``jax.default_matmul_precision``. A bf16 or f16
product clears torch's reduced-precision reduction flag for itself and
restores the caller's value, so that it accumulates in f32 as XLA does. No
operand whose type already is the result type is copied or cast.
With fusion on, a product of two 2-D operands that needs no collective
(one rank, or ``b`` replicated and ``a`` not split along its columns) is
deferred as a kernel node
(``fusion.defer_matmul``, the JAX package's Fusion 2.0 form): pending
operand chains graft in front of it, a bias, an activation or a
soft-threshold tail graft onto it, and the whole flushes as one program
that calls ``_product`` as the eager path does (never ``addmm``: a fused
epilogue would round once where eager rounds twice).
"""

from __future__ import annotations

import builtins
from typing import Optional, Sequence

import numpy as np
import torch

from .. import types
from .._operations import _apply, into, result_type
from ..dndarray import DNDarray
from ..stride_tricks import sanitize_axis

__all__ = [
    "dot",
    "matmul",
    "matrix_norm",
    "norm",
    "outer",
    "projection",
    "trace",
    "transpose",
    "tril",
    "triu",
    "vecdot",
    "vector_norm",
]

# the flag that lets cuBLAS reduce a product of each type in reduced precision
_REDUCED_PRECISION_FLAG = {
    torch.bfloat16: "allow_bf16_reduced_precision_reduction",
    torch.float16: "allow_fp16_reduced_precision_reduction",
}


_LIMB_BITS = 16
# 16-bit limbs multiply below 2^32; 2^20 such products add below 2^53,
# where float64 holds every integer
_EXACT_K = 1 << 20


def _exact(dtype: torch.dtype) -> builtins.bool:
    return not (dtype.is_floating_point or dtype.is_complex)


def _exact_products(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``torch.matmul(x, y)`` of exact tensors of one type, as int64 modulo
    2^64 (for bool, the count of true pairs). Each operand's int64 value is
    cut into the 16-bit limbs that its type's width needs; the limb
    products whose weight stays below 2^64 are float64 products over
    contraction chunks of ``_EXACT_K``, exact, and are added in int64."""
    width = 8 if x.dtype == torch.bool else torch.iinfo(x.dtype).bits
    limbs = -(-width // _LIMB_BITS)
    xi = x.view(torch.int64) if x.dtype == torch.uint64 else x.to(torch.int64)
    yi = y.view(torch.int64) if y.dtype == torch.uint64 else y.to(torch.int64)
    y_k = 0 if y.ndim == 1 else y.ndim - 2
    k = x.shape[-1]
    acc = None
    for k0 in range(0, builtins.max(k, 1), _EXACT_K):
        kc = builtins.min(_EXACT_K, k - k0)
        xs, ys = xi.narrow(-1, k0, kc), yi.narrow(y_k, k0, kc)
        xl = [((xs >> (_LIMB_BITS * i)) & 0xFFFF).to(torch.float64) for i in range(limbs)]
        yl = [((ys >> (_LIMB_BITS * j)) & 0xFFFF).to(torch.float64) for j in range(limbs)]
        for i in range(limbs):
            for j in range(limbs - i):
                part = torch.matmul(xl[i], yl[j]).to(torch.int64) << (_LIMB_BITS * (i + j))
                acc = part if acc is None else acc + part
    return acc


def _exact_result(acc: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """An int64 sum of products as ``dtype``: bool where positive, else
    modulo 2^w of the type's width."""
    if dtype == torch.bool:
        return acc > 0
    if dtype == torch.uint64:
        return acc.view(torch.uint64)
    signed = {torch.uint8: torch.int8, torch.uint16: torch.int16,
              torch.uint32: torch.int32}.get(dtype, dtype)
    return acc.to(signed).view(dtype)


def _product(x: torch.Tensor, y: torch.Tensor, accumulate: builtins.bool = False) -> torch.Tensor:
    """``torch.matmul``; a bf16 or f16 product accumulates in f32 (the
    reduced-precision flag cleared for it alone and restored after it, also
    when it raises). An exact product is :func:`_exact_products`, left as
    its int64 sum with ``accumulate`` (for a sum across ranks) and in the
    operands' type otherwise."""
    if _exact(x.dtype):
        acc = _exact_products(x, y)
        return acc if accumulate else _exact_result(acc, x.dtype)
    flag = _REDUCED_PRECISION_FLAG.get(x.dtype)
    if flag is None:
        return torch.matmul(x, y)
    flags = torch.backends.cuda.matmul
    caller = getattr(flags, flag)
    setattr(flags, flag, False)
    try:
        return torch.matmul(x, y)
    finally:
        setattr(flags, flag, caller)


def _replicated(t: torch.Tensor, like: DNDarray, dtype=None) -> DNDarray:
    dtype = types.canonical_heat_type(t.dtype) if dtype is None else dtype
    return DNDarray(t, tuple(t.shape), dtype, None, like.device, like.comm, True)


def _from_global(t: torch.Tensor, split, like: DNDarray, dtype=None) -> DNDarray:
    """Wrap a global tensor present on every rank: keep this rank's chunk."""
    from ..factories import _from_global as wrap

    return wrap(t, split, like.device, like.comm, dtype)


def _narrow_chunk(t: torch.Tensor, dim: int, comm) -> torch.Tensor:
    """This rank's ceil-rule chunk of ``t`` along ``dim``."""
    counts, displs = comm.counts_displs(t.shape[dim])
    return t.narrow(dim, displs[comm.rank], counts[comm.rank])


def dot(a: DNDarray, b: DNDarray, out: Optional[DNDarray] = None) -> DNDarray:
    """Dot product with numpy's dispatch (reference basics.py:42): 1-D × 1-D
    is a local dot and one allreduce; up to 2-D it is :func:`matmul`."""
    if isinstance(a, DNDarray) and isinstance(b, DNDarray) and a.ndim == 1 and b.ndim == 1:
        if a.shape != b.shape:
            raise ValueError("shapes are not aligned")
        if a.split != b.split:  # cut the replicated side to the split side's chunks
            a, b = (a.resplit(b.split), b) if a.split is None else (a, b.resplit(a.split))
        dtype = types.promote_types(a.dtype, b.dtype)
        tdt = dtype.torch_type()
        res = _product(a.larray.to(tdt), b.larray.to(tdt), accumulate=True)
        if a.split is not None:
            res = a.comm.allreduce(res)
        if _exact(tdt):
            res = _exact_result(res, tdt)
        return into(_replicated(res, a, dtype), out)
    if a.ndim <= 2 and b.ndim <= 2:
        return into(matmul(a, b), out)
    raise NotImplementedError("ht.dot not implemented for N-D × M-D arrays")


def _result_split(a: DNDarray, b: DNDarray, ndim_out: int) -> Optional[int]:
    """The JAX package's result split of ``matmul`` (basics.py:125-150 there)."""
    a_vec, b_vec = a.ndim == 1, b.ndim == 1
    out_split: Optional[int] = None
    if a.split is not None:
        if not a_vec and a.split == a.ndim - 2:
            out_split = ndim_out - (2 if not b_vec else 1)
        elif a.split < a.ndim - 2:
            out_split = a.split  # batch dim
        elif a.split == a.ndim - 1 and not b_vec:
            out_split = ndim_out - 2 if not a_vec else None
    if out_split is None and b.split is not None:
        if not b_vec and b.split == b.ndim - 1:
            out_split = ndim_out - 1
        elif b.ndim > 2 and b.split < b.ndim - 2:
            out_split = b.split
        elif not b_vec and b.split == b.ndim - 2 and not a_vec:
            out_split = ndim_out - 2
    if out_split is not None and out_split >= ndim_out:
        out_split = None
    return out_split


def matmul(a: DNDarray, b: DNDarray, allow_resplit: bool = False) -> DNDarray:
    """Matrix product of two (1-D, 2-D or batched N-D) DNDarrays (reference
    basics.py:108). Split rules for 2-D operands:

    =============  =============  ============
    a.split        b.split        result split
    =============  =============  ============
    None           None           None
    0              any            0
    None           1              1
    None           0              0 (contraction across ranks)
    1              any            0 (contraction across ranks)
    =============  =============  ============

    How each pair runs is in the module docstring. ``allow_resplit`` is
    accepted for API parity and changes nothing, as in the JAX package."""
    if not isinstance(a, DNDarray) or not isinstance(b, DNDarray):
        raise TypeError("both operands must be DNDarrays")
    if a.ndim == 1 and b.ndim == 1:
        return dot(a, b)

    out_dtype = types.promote_types(a.dtype, b.dtype)
    tdt = out_dtype.torch_type()
    a_vec, b_vec = a.ndim == 1, b.ndim == 1
    a_shape = (1,) + a.shape if a_vec else a.shape
    b_shape = b.shape + (1,) if b_vec else b.shape
    if a_shape[-1] != b_shape[-2]:
        raise ValueError(
            f"If the last dimension of a ({a.shape[-1]}) is not the same size "
            f"as the second-to-last dimension of b ({b.shape[-2 if b.ndim > 1 else -1]})."
        )
    comm = a.comm
    batch = tuple(np.broadcast_shapes(a_shape[:-2], b_shape[:-2])) \
        if (len(a_shape) > 2 or len(b_shape) > 2) else ()
    nb = len(batch)
    pshape = batch + (a_shape[-2], b_shape[-1])  # the result with both vectors promoted
    out_gshape = pshape[:-2] + ((pshape[-1],) if a_vec else pshape[-2:])
    if b_vec:
        out_gshape = out_gshape[:-1]
    out_split = _result_split(a, b, len(out_gshape))

    def promoted(x: DNDarray, t: torch.Tensor) -> torch.Tensor:
        t = t.to(tdt)  # no copy when the type already is the result type
        if x is a and a_vec:
            return t.unsqueeze(0)
        if x is b and b_vec:
            return t.unsqueeze(-1)
        return t

    def finish(res: torch.Tensor) -> DNDarray:
        if a_vec:
            res = res.squeeze(-2)
        if b_vec:
            res = res.squeeze(-1)
        return DNDarray(res, out_gshape, out_dtype, out_split, a.device, comm, True)

    if a.ndim == 2 and b.ndim == 2 and (comm.size == 1 or (b.split is None and a.split != 1)):
        # one local product (rows of a carried, or nothing split): deferrable
        from .. import fusion

        res = fusion.defer_matmul(a, b, tdt, out_dtype, out_gshape, out_split)
        if res is not None:
            return res
    if comm.size == 1 or (a.split is None and b.split is None):
        return finish(_product(promoted(a, a.larray), promoted(b, b.larray)))

    # splits in the promoted shapes; the contraction axis of each operand
    a_ps = None if a.split is None else a.split + (1 if a_vec else 0)
    b_ps = b.split
    ka, kb = len(a_shape) - 1, len(b_shape) - 2
    if out_split is None:
        psplit = None
    elif out_split < nb:
        psplit = out_split
    else:
        psplit = nb + 1 if a_vec else out_split

    if a_ps == ka or (a_ps is None and b_ps == kb):
        # contraction across ranks: the partial over this rank's K-chunk
        def k_chunk(x: DNDarray, ps, k):
            if ps == k:
                return promoted(x, x.larray)
            if ps is None:
                return _narrow_chunk(promoted(x, x.larray), k, comm)
            return promoted(x, x.resplit(k).larray)  # not a vector: k is its own axis

        partial = _product(k_chunk(a, a_ps, ka), k_chunk(b, b_ps, kb), accumulate=True)
        if psplit is None:
            summed = comm.allreduce(partial)
        else:
            summed = comm.reduce_scatter(partial, psplit, pshape[psplit])
        return finish(_exact_result(summed, tdt) if _exact(tdt) else summed)

    # carried: the operand that owns the result's split axis keeps its chunk
    def own_dim(xshape, carried_dim, carried_at):
        """The dimension of an operand (promoted shape ``xshape``) that
        becomes the result's split axis, or None."""
        if psplit < nb:
            d = psplit - (nb - (len(xshape) - 2))
            return d if d >= 0 else None
        return carried_dim if psplit == carried_at else None

    def carried(x: DNDarray, xshape, ps, dim):
        if ps is not None and ps == dim and xshape[dim] == pshape[psplit]:
            return promoted(x, x.larray)
        whole = promoted(x, x._global())
        if dim is not None and xshape[dim] == pshape[psplit]:
            whole = _narrow_chunk(whole, dim, comm)
        return whole

    a_dim = own_dim(a_shape, len(a_shape) - 2, nb)  # a's rows
    b_dim = own_dim(b_shape, len(b_shape) - 1, nb + 1)  # b's columns
    return finish(_product(carried(a, a_shape, a_ps, a_dim), carried(b, b_shape, b_ps, b_dim)))


def matrix_norm(x: DNDarray, axis=None, keepdims: bool = False, ord=None) -> DNDarray:
    """Matrix norm over an axis pair (reference basics.py `matrix_norm`)."""
    from .. import arithmetics, exponential, rounding, statistics

    if axis is None:
        if x.ndim == 2:
            row_axis, col_axis = 0, 1
        else:
            raise ValueError("input is not a matrix, specify axis")
    else:
        row_axis, col_axis = (sanitize_axis(x.shape, a) for a in axis)
    if row_axis == col_axis:
        raise ValueError("axis entries must be different")

    def _two_stage(sum_axis, ext_axis, extremum):
        # the first reduction drops sum_axis (unless keepdims), shifting the
        # second reduction's axis index
        second = ext_axis if keepdims or ext_axis < sum_axis else ext_axis - 1
        return extremum(
            arithmetics.sum(rounding.abs(x), axis=sum_axis, keepdims=keepdims),
            axis=second,
            keepdims=keepdims,
        )

    if ord == 1:
        return _two_stage(row_axis, col_axis, statistics.max)
    if ord == -1:
        return _two_stage(row_axis, col_axis, statistics.min)
    if ord == float("inf"):
        return _two_stage(col_axis, row_axis, statistics.max)
    if ord == -float("inf"):
        return _two_stage(col_axis, row_axis, statistics.min)
    if ord in (None, "fro"):
        return exponential.sqrt(
            arithmetics.sum(arithmetics.mul(x, x), axis=(row_axis, col_axis), keepdims=keepdims)
        )
    raise ValueError(f"Invalid norm order {ord!r} for matrices")


def norm(x: DNDarray, axis=None, keepdims: bool = False, ord=None) -> DNDarray:
    """Vector or matrix norm (reference basics.py `norm`)."""
    if axis is None and ord is None:
        from .. import arithmetics, exponential

        return exponential.sqrt(arithmetics.sum(arithmetics.mul(x, x)))
    if axis is None and x.ndim <= 1:
        return vector_norm(x, axis=None, keepdims=keepdims, ord=ord)
    if axis is None and x.ndim == 2:
        return matrix_norm(x, axis=None, keepdims=keepdims, ord=ord)
    if isinstance(axis, (tuple, list)) and len(axis) == 2:
        return matrix_norm(x, axis=axis, keepdims=keepdims, ord=ord)
    return vector_norm(x, axis=axis, keepdims=keepdims, ord=ord)


def outer(a: DNDarray, b: DNDarray, out: Optional[DNDarray] = None,
          split: Optional[int] = None) -> DNDarray:
    """Outer product of two vectors (reference basics.py:1056). For a split
    result the operand along the split axis keeps its chunk and the other
    is gathered whole on every rank (``allgather``)."""
    if not isinstance(a, DNDarray) or not isinstance(b, DNDarray):
        raise TypeError("both operands must be DNDarrays")
    if a.ndim != 1 or b.ndim != 1:
        raise TypeError("outer expects 1-D operands")
    if split is None:
        # the result splits along the operand that is already distributed
        split = 0 if a.split is not None else (1 if b.split is not None else None)
    if split is not None:
        split = sanitize_axis((a.shape[0], b.shape[0]), split)

    def chunk(v: DNDarray) -> torch.Tensor:
        return v.larray if v.split == 0 else v.resplit(0).larray

    rows = chunk(a) if split == 0 else a._global()
    cols = chunk(b) if split == 1 else b._global()
    dtype = result_type(rows, cols)
    res = _apply(torch.mul, rows.to(dtype)[:, None], cols.to(dtype)[None, :])
    return into(DNDarray(res, (a.shape[0], b.shape[0]), types.canonical_heat_type(dtype),
                         split, a.device, a.comm, True), out)


def projection(a: DNDarray, b: DNDarray) -> DNDarray:
    """Projection of a onto b (reference basics.py `projection`)."""
    from .. import arithmetics

    if a.ndim != 1 or b.ndim != 1:
        raise RuntimeError(f"a, b must be vectors, got {a.ndim}, {b.ndim} dimensions")
    scale = arithmetics.div(dot(a, b), dot(b, b))
    return arithmetics.mul(scale, b)


def _exact_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis; exact types add in int64, as the JAX
    package's sums do (its unsigned sums are uint64: the caller views the
    bits as such after any allreduce)."""
    if t.is_floating_point() or t.is_complex():
        return t.sum(-1)
    return (t.view(torch.int64) if t.dtype == torch.uint64 else t.to(torch.int64)).sum(-1)


def trace(a: DNDarray, offset: int = 0, axis1: int = 0, axis2: int = 1, dtype=None, out=None):
    """Sum along diagonals (reference basics.py:1313). A split 2-D matrix
    sums the diagonal entries of its own chunk on each rank and allreduces;
    it never gathers."""
    if a.ndim < 2:
        raise ValueError("trace needs an array of at least 2 dimensions")
    axis1 = sanitize_axis(a.shape, axis1)
    axis2 = sanitize_axis(a.shape, axis2)
    unsigned = a.larray.dtype in (torch.uint8, torch.uint16, torch.uint32, torch.uint64)
    split_2d = a.ndim == 2 and a.split is not None and a.comm.size > 1
    if split_2d and (axis1, axis2) in ((0, 1), (1, 0)):
        off = -offset if (axis1, axis2) == (1, 0) else offset
        n, m = a.shape
        counts, displs = a.comm.counts_displs(a.shape[a.split])
        start, stop = displs[a.comm.rank], displs[a.comm.rank] + counts[a.comm.rank]
        # the global diagonal entries (i, i + off) whose row (column) is in this chunk
        if a.split == 0:
            lo, hi = max(start, -off), min(stop, m - off)
            idx = torch.arange(lo, max(hi, lo), device=a.larray.device)
            picked = a.larray[idx - start, idx + off]
        else:
            lo, hi = max(start, off), min(stop, n + off)
            idx = torch.arange(lo, max(hi, lo), device=a.larray.device)
            picked = a.larray[idx - off, idx - start]
        res = a.comm.allreduce(_exact_sum(picked))
    else:
        res = _exact_sum(torch.diagonal(a._global(), offset, axis1, axis2))
    if unsigned:
        res = res.view(torch.uint64)
    if dtype is not None:
        res = res.to(types.canonical_heat_type(dtype).torch_type())
    return into(_replicated(res, a), out)


def transpose(a: DNDarray, axes: Optional[Sequence[int]] = None) -> DNDarray:
    """Permute dimensions (reference basics.py:1735): a local permute of
    this rank's chunk, and the split axis follows its dimension."""
    if axes is None:
        axes = tuple(reversed(range(a.ndim)))
    else:
        axes = tuple(sanitize_axis(a.shape, ax) for ax in axes)
        if len(axes) != a.ndim or len(set(axes)) != a.ndim:
            raise ValueError(f"axes do not match tensor of dimension {a.ndim}")
    res = a.larray.permute(axes)
    out_split = axes.index(a.split) if a.split is not None else None
    out_gshape = tuple(a.shape[ax] for ax in axes)
    return DNDarray(res, out_gshape, a.dtype, out_split, a.device, a.comm, True)


def _tri_op(m: DNDarray, k: int, op) -> DNDarray:
    """Lower or upper triangle (reference basics.py:1805). A 1-D array is
    tiled into a square first. The diagonal is global: a chunk of rows (or
    columns) starting at ``s`` shifts it by ``s`` (by ``-s``)."""
    if m.ndim < 1:
        raise TypeError("input needs to be a tensor with at least 1 dimension")
    if m.ndim == 1:
        log = m._global()
        mat = log.unsqueeze(0).expand(log.shape[0], log.shape[0])
        return _from_global(op(mat, k), 0 if m.split is not None else None, m, m.dtype)
    shift = 0
    if m.split is not None and m.split >= m.ndim - 2:
        _, displs = m.comm.counts_displs(m.shape[m.split])
        start = displs[m.comm.rank]
        shift = start if m.split == m.ndim - 2 else -start
    res = op(m.larray, k + shift)
    return DNDarray(res, m.shape, m.dtype, m.split, m.device, m.comm, True)


def tril(m: DNDarray, k: int = 0) -> DNDarray:
    """Lower triangle (reference basics.py `tril`)."""
    return _tri_op(m, k, torch.tril)


def triu(m: DNDarray, k: int = 0) -> DNDarray:
    """Upper triangle (reference basics.py `triu`)."""
    return _tri_op(m, k, torch.triu)


def vecdot(x1: DNDarray, x2: DNDarray, axis: Optional[int] = None,
           keepdims: bool = False) -> DNDarray:
    """Vector dot product along an axis (reference basics.py `vecdot`)."""
    from .. import arithmetics

    m = arithmetics.mul(x1, x2)
    if axis is None:
        axis = m.ndim - 1
    return arithmetics.sum(m, axis=axis, keepdims=keepdims)


def vector_norm(x: DNDarray, axis=None, keepdims: bool = False, ord=None) -> DNDarray:
    """Vector norm (reference basics.py `vector_norm`)."""
    from .. import arithmetics, exponential, relational, rounding, statistics

    if axis is not None and not isinstance(axis, (builtins.int, np.integer)):
        raise TypeError("axis must be an integer or None for vectors")
    if ord is None or ord == 2:
        return exponential.sqrt(arithmetics.sum(arithmetics.mul(x, x), axis=axis,
                                                keepdims=keepdims))
    absx = rounding.abs(x)
    if ord == float("inf"):
        return statistics.max(absx, axis=axis, keepdims=keepdims)
    if ord == -float("inf"):
        return statistics.min(absx, axis=axis, keepdims=keepdims)
    if ord == 0:
        nz = relational.ne(x, 0)
        return arithmetics.sum(nz.astype(types.float32), axis=axis, keepdims=keepdims)
    if isinstance(ord, (builtins.int, builtins.float)):
        p = arithmetics.pow(absx, float(ord))
        s = arithmetics.sum(p, axis=axis, keepdims=keepdims)
        return arithmetics.pow(s, 1.0 / float(ord))
    raise ValueError(f"Invalid norm order {ord!r} for vectors")


DNDarray.__matmul__ = lambda self, other: matmul(self, other)
DNDarray.transpose = lambda self, axes=None: transpose(self, axes)
DNDarray.dot = lambda self, other, out=None: dot(self, other, out)
DNDarray.tril = lambda self, k=0: tril(self, k)
DNDarray.triu = lambda self, k=0: triu(self, k)
