"""Compressed collective payloads (counterpart of ``heat_tpu/core/collective_prec.py``).

The wire modes of the JAX package, with its arithmetic:

* ``off`` — the exact collective;
* ``bf16`` — cast, move, cast back: half the bytes of an f32 payload. A
  summing collective sums in bf16 (NCCL and gloo both do; the JAX package
  on the CPU sums a bf16 all-reduce in f32, ``allreduce_wire_dtype`` there);
* ``int8`` — one max-abs scale a tensor (``_scale_of``: ``amax / 127`` in f32,
  rounded to bf16, 1 where the tensor is zero), ``round`` half to even onto
  ``[-127, 127]``, the int8 payload and the bf16 scale on the wire;
* ``blockwise`` — the same with one scale a block of
  ``HEAT_TPU_COLLECTIVE_PREC_BLOCK`` elements (default 128).

A quantized sum is the JAX package's two-phase form: each rank quantizes its
partial into ``p`` per-destination chunks, one all-to-all collects every
rank's partial of a chunk, the chunk is dequantized and summed in f32,
requantized, and one all-gather brings the chunks to every rank:
``2·B/4·(p-1)`` wire bytes for an f32 payload instead of the ring's
``2·B·(p-1)``, at most ``(p+1)`` quantization steps of error an element.
Integer payloads always move exact.

The JAX package runs these inside ``shard_map`` over a mesh axis (its
``axis_name``/``axis_index_groups``); here each takes the
:class:`~heat_tpu_torch.core.communication.TorchCommunication` of the ranks
that take part (a tier's communicator for a tier) and issues its movers
through it (``exchange``, ``gather_stack``, ``sum``, ``sum_scatter``,
``ppermute``), so the collective audit sees each at its wire's type. A
bf16 payload moves as bf16: data movement does no arithmetic on it.

:func:`local_roundtrip` is bit for bit the JAX package's (``torch.round``
and ``jnp.round`` both round half to even, and the scale is the same bf16
value), so ``compressed_collective(x) == exact_collective(local_roundtrip(x))``
holds for the movers. :func:`reshard` is the counterpart of
``gspmd_reshard`` (:578): the compressed ``resplit`` with the JAX package's
scales (a per-tensor scale from one scalar max all-reduce, or blockwise
scales along the last axis replicated by one all-gather).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .. import _knobs as knobs
from ..telemetry import collectives as _cost

__all__ = [
    "DEFAULT_BLOCK",
    "MODES",
    "all_gather",
    "all_to_all",
    "allreduce_wire_dtype",
    "block_size",
    "blockwise_axis_ok",
    "blockwise_segments",
    "compressible",
    "effective",
    "exchange",
    "local_roundtrip",
    "mode",
    "pmean",
    "ppermute",
    "psum",
    "quant_error_bound",
    "reduce_scatter",
    "reshard",
    "resolve",
]

MODES = ("off", "bf16", "int8", "blockwise")
_ENV_MODE = "HEAT_TPU_COLLECTIVE_PREC"
_ENV_BLOCK = "HEAT_TPU_COLLECTIVE_PREC_BLOCK"

# one scale a block of this many elements; the cost model carries the same
# default so predictions and collectives agree
DEFAULT_BLOCK = _cost.DEFAULT_WIRE_BLOCK


def mode() -> str:
    """The ``HEAT_TPU_COLLECTIVE_PREC`` value (malformed -> ``off``)."""
    raw = (knobs.raw(_ENV_MODE, "") or "").strip().lower()
    return raw if raw in MODES else "off"


def block_size() -> int:
    """The blockwise scale granularity (``HEAT_TPU_COLLECTIVE_PREC_BLOCK``;
    malformed or non-positive -> :data:`DEFAULT_BLOCK`)."""
    raw = (knobs.raw(_ENV_BLOCK, "") or "").strip()
    if raw:
        try:
            n = int(raw)
            if n > 0:
                return n
        except ValueError:
            pass
    return DEFAULT_BLOCK


def resolve(precision: Optional[str] = None) -> str:
    """An explicit ``precision`` wins over the knob; ``None`` reads
    :func:`mode`. An unknown value raises."""
    if precision is None:
        return mode()
    p = str(precision).strip().lower()
    if p not in MODES:
        raise ValueError(f"precision must be one of {MODES}, got {precision!r}")
    return p


def compressible(dtype) -> bool:
    """Only floating payloads compress (a torch or numpy type, or its
    name); integers, booleans and complex numbers move exact."""
    if isinstance(dtype, torch.dtype):
        return dtype.is_floating_point
    if str(dtype) == "bfloat16":
        return True
    try:
        return bool(np.issubdtype(np.dtype(dtype), np.floating))
    except TypeError:
        return False


def effective(dtype, precision: Optional[str] = None) -> str:
    """The wire one payload gets: the resolved mode, ``off`` for a
    non-float type."""
    m = resolve(precision)
    if m == "off" or not compressible(dtype):
        return "off"
    return m


def blockwise_axis_ok(shape: Sequence[int], split: Optional[int]) -> bool:
    """Whether the resplit's blockwise layout applies: blocks run along
    the last axis, a real axis other than the split one."""
    return len(shape) >= 2 and split != len(shape) - 1 and int(shape[-1]) > 0


def blockwise_segments(extent: int, block: int) -> Tuple[int, int]:
    """``(n_blocks, segment)`` of a last axis of ``extent``: even
    ``block``-sized segments when they divide it, else one whole-row
    segment (the cost model's rule)."""
    extent = int(extent)
    if extent >= block and extent % block == 0:
        return extent // block, block
    return 1, extent


def allreduce_wire_dtype(dtype, platform: Optional[str] = None) -> str:
    """The element type a summing all-reduce of this payload moves: its
    own, on the card (NCCL) and on the CPU (gloo) alike (the JAX package's
    CPU backend moves a bf16 or f16 sum as f32)."""
    name = str(dtype).replace("torch.", "")
    return {"bfloat16": "bf16", "float16": "f16", "float32": "f32",
            "float64": "f64"}.get(name, name)


# -- quantization arithmetic ---------------------------------------------------


def _scale_of(amax: torch.Tensor) -> torch.Tensor:
    """Zero-safe symmetric scale in bf16: ``amax / 127`` (f32), or 1 where
    the group is zero."""
    s = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    return s.to(torch.bfloat16)


def _round_q(values: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(values / scale.float()), -127.0, 127.0).to(torch.int8)


def _quant_tensor(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor quantization: ``(q int8, scale bf16 scalar)``."""
    xf = x.float()
    s = _scale_of(xf.abs().max())
    return _round_q(xf, s), s


def _quant_flat_blocks(x: torch.Tensor, block: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat blockwise quantization: ``x`` raveled and zero-padded to whole
    blocks (a payload under one block is one block of its own size);
    returns ``(q int8 (nblk, block), scales bf16 (nblk,))``."""
    n = x.numel()
    block = max(1, min(block, n))
    nblk = max(1, -(-n // block))
    flat = x.reshape(-1).float()
    if nblk * block != n:
        flat = torch.nn.functional.pad(flat, (0, nblk * block - n))
    b = flat.reshape(nblk, block)
    s = _scale_of(b.abs().amax(dim=1))
    return _round_q(b, s[:, None]), s


def _deq(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """int8 payload times bf16 scale, in f32."""
    return q.float() * s.float()


def _dequant_flat_blocks(q, s, n: int, shape, dtype) -> torch.Tensor:
    return _deq(q, s[..., None]).reshape(-1)[:n].reshape(shape).to(dtype)


def local_roundtrip(x: torch.Tensor, mode_: str, block: Optional[int] = None) -> torch.Tensor:
    """Quantize and dequantize with no collective: what a compressed
    ``ppermute``/``all_gather`` delivers to a peer."""
    if mode_ == "off" or not compressible(x.dtype):
        return x
    if mode_ == "bf16":
        return x.to(torch.bfloat16).to(x.dtype)
    if mode_ == "int8":
        q, s = _quant_tensor(x)
        return _deq(q, s).to(x.dtype)
    q, s = _quant_flat_blocks(x, block or block_size())
    return _dequant_flat_blocks(q, s, x.numel(), x.shape, x.dtype)


def quant_error_bound(x, mode_: str, hops: int = 1) -> float:
    """The per-element absolute error bound of ``hops`` quantization steps
    of ``x`` (an array or its max-abs): ``0`` exact; ``bf16`` ``2^-8`` of the
    max-abs a hop; ``int8``/``blockwise`` ``amax / 254`` a hop (blockwise
    bounded by the global max-abs). A non-finite payload gives ``inf``."""
    if hasattr(x, "dtype") and not compressible(x.dtype):
        return 0.0
    if isinstance(x, torch.Tensor):
        amax = float(x.detach().abs().max().cpu().double()) if x.numel() else 0.0
    elif hasattr(x, "ndim"):
        amax = float(np.max(np.abs(np.asarray(x))))
    else:
        amax = float(x)
    if not np.isfinite(amax):
        return float("inf")
    if mode_ == "off":
        return 0.0
    if mode_ == "bf16":
        return amax * (2.0 ** -8) * max(1, int(hops))
    return amax / 254.0 * max(1, int(hops))


# -- compressed collectives -----------------------------------------------------


def ppermute(x: torch.Tensor, comm, perm, mode_: str, block: Optional[int] = None):
    """Compressed hop along ``perm``: int8/bf16 and the scales travel, the
    receiver dequantizes (a rank that receives nothing gets zeros)."""
    if mode_ == "off" or not compressible(x.dtype):
        return comm.ppermute(x, perm, "off")
    hop = lambda u: comm.ppermute(u, perm, "off")  # noqa: E731
    if mode_ == "bf16":
        return hop(x.to(torch.bfloat16)).to(x.dtype)
    if mode_ == "int8":
        q, s = _quant_tensor(x)
        return _deq(hop(q), hop(s.reshape(1))[0]).to(x.dtype)
    q, s = _quant_flat_blocks(x, block or block_size())
    q, s = hop(q), hop(s)
    return _dequant_flat_blocks(q, s, x.numel(), x.shape, x.dtype)


def all_gather(x: torch.Tensor, comm, mode_: str, block: Optional[int] = None,
               tiled: bool = True, name: str = "all_gather") -> torch.Tensor:
    """All-gather of every rank's ``x`` (one shape on every rank) at
    ``mode_``'s wire: stacked ``(p,) + x.shape``, or concatenated along
    dimension 0 with ``tiled``. Each rank quantizes its block once; every
    mover reports under ``name``."""
    p = comm.size
    gather = lambda u: comm.gather_stack(u, name)  # noqa: E731
    if mode_ == "off" or not compressible(x.dtype):
        g = gather(x)
    elif mode_ == "bf16":
        g = gather(x.to(torch.bfloat16)).to(x.dtype)
    elif mode_ == "int8":
        q, s = _quant_tensor(x)
        qg, sg = gather(q), gather(s)
        g = _deq(qg, sg.reshape((p,) + (1,) * x.dim())).to(x.dtype)
    else:
        q, s = _quant_flat_blocks(x, block or block_size())
        qg, sg = gather(q), gather(s)
        g = _deq(qg, sg[..., None]).reshape(p, -1)[:, :x.numel()]
        g = g.reshape((p,) + tuple(x.shape)).to(x.dtype)
    if tiled and x.dim() >= 1:
        return g.reshape((p * x.shape[0],) + tuple(x.shape[1:]))
    return g


def _quant_scatter_phase(x: torch.Tensor, comm, mode_: str, block: int, name: str):
    """The first phase of a quantized sum: this rank's partial quantized
    into ``p`` per-destination chunks, exchanged (each rank collects every
    partial of its chunk), dequantized and summed in f32. Returns ``(red,
    chunk)``, ``red`` the f32 ``(chunk,)`` sum of this rank's chunk."""
    nproc = comm.size
    n = x.numel()
    chunk = -(-n // nproc)
    if mode_ == "blockwise":
        block = max(1, min(block, chunk))
        chunk = -(-chunk // block) * block
    flat = x.reshape(-1).float()
    if chunk * nproc != n:
        flat = torch.nn.functional.pad(flat, (0, chunk * nproc - n))
    parts = flat.reshape(nproc, chunk)
    if mode_ == "int8":
        s = _scale_of(parts.abs().max())
        qt = comm.exchange(_round_q(parts, s), name)
        # the scale rides an all-to-all beside its payload (the cost model's
        # form): a copy to every destination
        sg = comm.exchange(s.reshape(1).expand(nproc).contiguous(), name)
        deq = _deq(qt, sg[:, None])
    else:
        b3 = parts.reshape(nproc, chunk // block, block)
        s = _scale_of(b3.abs().amax(dim=2))
        qt = comm.exchange(_round_q(b3, s[..., None]), name)
        st = comm.exchange(s, name)
        deq = _deq(qt, st[..., None]).reshape(nproc, chunk)
    return deq.sum(dim=0), chunk


def reduce_scatter(x: torch.Tensor, comm, mode_: str, block: Optional[int] = None,
                   name: str = "reduce_scatter"):
    """Reduce-scatter of ``x`` flattened and zero-padded to ``p`` equal
    chunks at ``mode_``'s wire: rank ``i`` gets the 1-D chunk ``i`` of the
    sum in ``x``'s type. ``bf16`` sums in bf16; ``int8``/``blockwise`` are
    the first phase alone (blockwise may return a chunk padded to whole
    blocks). Every mover reports under ``name``."""
    nproc = comm.size
    n = x.numel()
    chunk = -(-n // nproc)
    if mode_ in ("off", "bf16") or not compressible(x.dtype):
        flat = x.reshape(-1)
        if mode_ == "bf16" and compressible(x.dtype):
            flat = flat.to(torch.bfloat16)
        if chunk * nproc != n:
            flat = torch.nn.functional.pad(flat, (0, chunk * nproc - n))
        return comm.sum_scatter(flat, name).to(x.dtype)
    red, _ = _quant_scatter_phase(x, comm, mode_, block or block_size(), name)
    return red.to(x.dtype)


def psum(x: torch.Tensor, comm, mode_: str, block: Optional[int] = None, name: str = "sum",
         out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sum over the ranks at ``mode_``'s wire, into ``out`` (a new tensor
    when None; ``x`` itself sums in place): ``off`` the all-reduce,
    ``bf16`` the all-reduce of a bf16 payload, ``int8``/``blockwise`` the
    two-phase quantized sum (module docstring). Every mover reports under
    ``name``."""
    if mode_ == "off" or not compressible(x.dtype):
        return comm.sum(x, name, out=out)
    if mode_ == "bf16":
        total = comm.sum(x.to(torch.bfloat16), name).to(x.dtype)
    else:
        nproc = comm.size
        block = block or block_size()
        n = x.numel()
        red, chunk = _quant_scatter_phase(x, comm, mode_, block, name)
        if mode_ == "int8":
            s2 = _scale_of(red.abs().max())
            q2g = comm.gather_stack(_round_q(red, s2), name)
            s2g = comm.gather_stack(s2, name)
            total = _deq(q2g, s2g[:, None])
        else:
            block = max(1, min(block, -(-n // nproc)))
            rb = red.reshape(chunk // block, block)
            s2 = _scale_of(rb.abs().amax(dim=1))
            q2g = comm.gather_stack(_round_q(rb, s2[:, None]), name)
            s2g = comm.gather_stack(s2, name)
            total = _deq(q2g, s2g[..., None]).reshape(nproc, chunk)
        total = total.reshape(-1)[:n].reshape(x.shape).to(x.dtype)
    if out is None:
        return total
    with torch.no_grad():
        return out.copy_(total)


def pmean(x: torch.Tensor, comm, mode_: str, block: Optional[int] = None) -> torch.Tensor:
    """Compressed mean: :func:`psum` divided by the world size."""
    if mode_ == "off" or not compressible(x.dtype):
        return comm.sum(x) / comm.size
    return (psum(x, comm, mode_, block) / comm.size).to(x.dtype)


def exchange(slabs: torch.Tensor, comm, mode_: str, block: Optional[int] = None,
             name: str = "exchange") -> torch.Tensor:
    """All-to-all of equal slabs (``slabs[q]`` to rank ``q``; row ``r`` of
    the result from rank ``r``) at ``mode_``'s wire: each slab quantized on
    its own (one scale a slab in ``int8``, flat blocks in ``blockwise``),
    the scales on an all-to-all of their own. Every mover reports under
    ``name``."""
    if mode_ == "off" or not compressible(slabs.dtype):
        return comm.exchange(slabs, name)
    if mode_ == "bf16":
        return comm.exchange(slabs.to(torch.bfloat16), name).to(slabs.dtype)
    nproc = slabs.shape[0]
    m = slabs[0].numel()
    flat = slabs.reshape(nproc, m).float()
    if mode_ == "int8":
        nb, seg = 1, m
    else:
        seg = max(1, min(block or block_size(), m))
        nb = max(1, -(-m // seg))
        if nb * seg != m:
            flat = torch.nn.functional.pad(flat, (0, nb * seg - m))
    b3 = flat.reshape(nproc, nb, seg)
    s = _scale_of(b3.abs().amax(dim=2))
    qt = comm.exchange(_round_q(b3, s[..., None]), name)
    st = comm.exchange(s, name)
    deq = _deq(qt, st[..., None]).reshape(nproc, -1)[:, :m]
    return deq.reshape(slabs.shape).to(slabs.dtype)


def all_to_all(x: torch.Tensor, comm, split_axis: int, concat_axis: int, mode_: str,
               block: Optional[int] = None) -> torch.Tensor:
    """Compressed tiled all-to-all (``lax.all_to_all(tiled=True)``'s
    contract): ``x``'s ``split_axis`` (divisible by ``p``) is cut into
    ``p`` slabs, slab ``i`` goes to rank ``i``, and the received slabs are
    concatenated along ``concat_axis`` in source order."""
    p = comm.size
    xm = x.movedim(split_axis, 0)
    w = xm.shape[0] // p
    slabs = xm.reshape((p, w) + tuple(xm.shape[1:])).contiguous()
    out = exchange(slabs, comm, mode_, block)                 # (p, w, *rest)
    out = out.movedim(1, 1 + split_axis).movedim(0, concat_axis)
    shp = list(out.shape)
    shp[concat_axis:concat_axis + 2] = [shp[concat_axis] * shp[concat_axis + 1]]
    return out.reshape(shp)


# -- the compressed resplit -------------------------------------------------------


def reshard(b, dst_split: Optional[int], mode_: str, block: Optional[int] = None) -> torch.Tensor:
    """This rank's part of DNDarray ``b`` relaid out along ``dst_split``
    with the payload compressed (the counterpart of ``gspmd_reshard``):

    * ``bf16``: the bf16 payload moves;
    * ``blockwise`` when the blocks can run along the last axis
      (:func:`blockwise_axis_ok`, :func:`blockwise_segments`): scales per
      row segment, computed on the source rank, replicated by one
      all-gather of the scales along the source split;
    * otherwise (``int8``, blockwise on other shapes) one per-tensor scale
      from one scalar max all-reduce of the max-abs.

    The int8 payload moves by the exact relayout; dequantized after."""
    comm, src_split = b.comm, b.split
    shape, dtype = tuple(b.shape), b.larray.dtype
    x = b.larray

    def move(t: torch.Tensor) -> torch.Tensor:
        """``t`` (laid out as ``b``) moved along ``dst_split`` exactly."""
        if dst_split is None:
            return comm.allgather(t, src_split, shape[src_split])
        moved = comm.all_to_all(t, dst_split, src_split, shape[dst_split], shape[src_split])
        return moved.contiguous()

    if mode_ == "bf16":
        return move(x.to(torch.bfloat16)).to(dtype)
    block = block or block_size()
    if mode_ == "blockwise" and blockwise_axis_ok(shape, src_split):
        nb, seg = blockwise_segments(shape[-1], block)
        xb = x.float().reshape(tuple(x.shape[:-1]) + (nb, seg))
        s = _scale_of(xb.abs().amax(dim=-1))                      # (..., nb) local rows
        q = _round_q(xb, s[..., None]).reshape(x.shape)
        q = move(q)
        s_all = comm.allgather(s, src_split, shape[src_split])    # replicated scales
        if dst_split is not None:
            _, _, slices = comm.chunk(shape, dst_split)
            if dst_split == len(shape) - 1:
                lo, hi = slices[-1].start, slices[-1].stop
                cols = torch.arange(lo, hi, device=q.device) // seg
                return (q.float() * s_all.float()[..., cols]).to(dtype)
            s_all = s_all[slices[:-1]]
        deq = _deq(q.reshape(tuple(q.shape[:-1]) + (nb, seg)), s_all[..., None])
        return deq.reshape(q.shape).to(dtype)
    amax = x.float().abs().max() if x.numel() else torch.zeros((), device=x.device)
    amax = comm.allreduce(amax.reshape(1).clone(), op="max")[0]
    s = _scale_of(amax)
    return _deq(move(_round_q(x.float(), s)), s).to(dtype)
