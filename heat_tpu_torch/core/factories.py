"""Array construction routines.

Counterpart of ``heat_tpu/core/factories.py``. ``array(obj, split=s)``
takes the *global* data on every rank and keeps this rank's ceil-rule
chunk; ``is_split=s`` declares ``obj`` to be this rank's own chunk and
infers the global shape from every rank's length (reference
factories.py:386-429). Chunks that do not follow the ceil rule are
redistributed to it.
"""

from __future__ import annotations

import builtins
import math
from typing import Any, Optional, Type, Union

import numpy as np
import torch

from . import types
from .communication import TorchCommunication, sanitize_comm
from .devices import Device, sanitize_device
from .dndarray import DNDarray
from .stride_tricks import sanitize_axis, sanitize_shape

__all__ = [
    "arange",
    "array",
    "asarray",
    "empty",
    "empty_like",
    "eye",
    "full",
    "full_like",
    "linspace",
    "logspace",
    "meshgrid",
    "ones",
    "ones_like",
    "zeros",
    "zeros_like",
]


def _from_global(data: torch.Tensor, split, device: Device, comm: TorchCommunication,
                 dtype=None) -> DNDarray:
    """Wrap a global tensor already on this rank's device: keep this rank's
    chunk of the split dimension."""
    gshape = tuple(data.shape)
    split = sanitize_axis(gshape, split)
    if split is not None:
        _, _, slices = comm.chunk(gshape, split)
        data = data[slices].contiguous()
    ht_dtype = dtype if dtype is not None else types.canonical_heat_type(data.dtype)
    return DNDarray(data, gshape, ht_dtype, split, device, comm, True)


def _to_tensor(obj: Any, dtype, tdev: torch.device) -> torch.Tensor:
    """Host or device data as a tensor on ``tdev``, with the JAX package's
    type defaults: python floats → float32, python ints → int64, numpy
    arrays keep their dtype."""
    if isinstance(obj, torch.Tensor):
        data = obj.to(tdev)
        if dtype is not None:
            data = data.to(dtype.torch_type())
        return data
    arr = np.asarray(obj)
    if dtype is None and arr.dtype == np.float64 and not isinstance(obj, np.ndarray):
        arr = arr.astype(np.float32)
    data = torch.tensor(arr).to(tdev)  # a copy: never aliases the caller's buffer
    if dtype is not None:
        data = data.to(dtype.torch_type())
    return data


def array(
    obj: Any,
    dtype: Optional[Type[types.datatype]] = None,
    copy: Optional[bool] = True,
    ndmin: int = 0,
    split: Optional[int] = None,
    is_split: Optional[int] = None,
    device: Optional[Union[str, Device]] = None,
    comm: Optional[TorchCommunication] = None,
) -> DNDarray:
    """The main constructor (reference factories.py:150)."""
    if split is not None and is_split is not None:
        raise ValueError("split and is_split are mutually exclusive parameters")
    device = sanitize_device(device)
    tdev = device.torch_device
    comm = sanitize_comm(comm)
    if dtype is not None:
        dtype = types.canonical_heat_type(dtype)

    if isinstance(obj, DNDarray):
        if dtype is None and split is None and is_split is None:
            if not copy:
                return obj
            return DNDarray(obj.larray.clone(), obj.shape, obj.dtype, obj.split,
                            obj.device, obj.comm, True)
        data = obj._global()
        if dtype is not None:
            data = data.to(dtype.torch_type())
        tgt = split if split is not None else (obj.split if is_split is None else is_split)
        return _from_global(data.to(tdev), tgt, device, comm, dtype)

    data = _to_tensor(obj, dtype, tdev)
    if copy and isinstance(obj, torch.Tensor) and data.data_ptr() == obj.data_ptr():
        data = data.clone()
    while data.ndim < ndmin:
        data = data[None]

    if is_split is not None:
        is_split = sanitize_axis(tuple(data.shape), is_split)
        lens = comm.allgather_object(int(data.shape[is_split]))
        n = int(sum(lens))
        gshape = tuple(data.shape[:is_split]) + (n,) + tuple(data.shape[is_split + 1:])
        if comm.size > 1:  # one rank's block is the whole array, as one process's in JAX
            from . import program_cache

            chunk = program_cache.cached_program(
                "is_split_gather", (is_split, data.ndim), lambda: _rechunk, comm=comm,
                inline=True)(data, is_split, tuple(lens), gshape, comm)
        else:
            chunk = data.contiguous()
        ht_dtype = dtype if dtype is not None else types.canonical_heat_type(data.dtype)
        return DNDarray(chunk, gshape, ht_dtype, is_split, device, comm, True)

    return _from_global(data, split, device, comm, dtype)


def _rechunk(local: torch.Tensor, dim: int, lens: tuple, gshape: tuple,
             comm: TorchCommunication) -> torch.Tensor:
    """This rank's ceil-rule chunk of an array whose rank ``r`` holds a
    block of ``lens[r]`` rows along ``dim`` (the registry program of site
    ``is_split_gather``): the block itself when the blocks already follow
    the rule, else every block (padded to the longest) gathered by the
    communicator's audited all-gather and this rank's chunk cut out."""
    if list(lens) == list(comm.counts_displs(gshape[dim])[0]):
        return local.contiguous()
    shape = list(local.shape)
    shape[dim] = max(lens)
    buf = local.new_zeros(shape)
    buf.narrow(dim, 0, local.shape[dim]).copy_(local)
    stacked = comm.gather_stack(buf.contiguous(), name="all_gather")
    whole = torch.cat([stacked[r].narrow(dim, 0, ln) for r, ln in enumerate(lens)], dim=dim)
    _, _, slices = comm.chunk(gshape, dim)
    return whole[slices].contiguous()


def asarray(obj, dtype=None, copy=None, is_split=None, split=None, device=None, comm=None) -> DNDarray:
    """Convert to a DNDarray without copying where possible."""
    return array(obj, dtype=dtype, copy=bool(copy), split=split, is_split=is_split,
                 device=device, comm=comm)


def _local_factory(fill, shape, dtype, split, device, comm) -> DNDarray:
    gshape = sanitize_shape(shape)
    dtype = types.canonical_heat_type(dtype)
    device = sanitize_device(device)
    comm = sanitize_comm(comm)
    split = sanitize_axis(gshape, split)
    _, lshape, _ = comm.chunk(gshape, split)
    data = fill(lshape, dtype.torch_type(), device.torch_device)
    return DNDarray(data, gshape, dtype, split, device, comm, True)


def zeros(shape, dtype=types.float32, split=None, device=None, comm=None) -> DNDarray:
    return _local_factory(lambda s, t, d: torch.zeros(s, dtype=t, device=d),
                          shape, dtype, split, device, comm)


def ones(shape, dtype=types.float32, split=None, device=None, comm=None) -> DNDarray:
    return _local_factory(lambda s, t, d: torch.ones(s, dtype=t, device=d),
                          shape, dtype, split, device, comm)


def empty(shape, dtype=types.float32, split=None, device=None, comm=None) -> DNDarray:
    return _local_factory(lambda s, t, d: torch.empty(s, dtype=t, device=d),
                          shape, dtype, split, device, comm)


def full(shape, fill_value, dtype=types.float32, split=None, device=None, comm=None) -> DNDarray:
    return _local_factory(lambda s, t, d: torch.full(s, fill_value, dtype=t, device=d),
                          shape, dtype, split, device, comm)


def arange(*args, dtype=None, split=None, device=None, comm=None) -> DNDarray:
    """Evenly spaced values in [start, stop) with step (reference
    factories.py:40). Integer arguments of an exact type count exactly;
    otherwise the elements are numpy's, as ``jnp.arange`` gives them: the
    first two rounded to the type, then ``first + i * delta`` computed in
    the type (float32 for the 16-bit floats), ``delta`` their
    difference."""
    if len(args) == 1:
        start, stop, step = 0, args[0], 1
    elif len(args) == 2:
        start, stop, step = args[0], args[1], 1
    elif len(args) == 3:
        start, stop, step = args
    else:
        raise TypeError(
            f"function takes minimum one and at most 3 positional arguments ({len(args)} given)"
        )
    if dtype is None:
        all_int = all(isinstance(a, int) for a in (start, stop, step))
        dtype = types.int64 if all_int else types.float32
    dtype = types.canonical_heat_type(dtype)
    device = sanitize_device(device)
    comm = sanitize_comm(comm)
    t, dev = dtype.torch_type(), device.torch_device
    if all(isinstance(a, int) for a in (start, stop, step)) and not (
            t.is_floating_point or t.is_complex):
        data = torch.arange(start, stop, step, dtype=t, device=dev)
    else:
        n = builtins.max(math.ceil((stop - start) / step), 0)
        work = torch.float32 if t in (torch.float16, torch.bfloat16) else t
        first = torch.tensor(start, dtype=t, device=dev).to(work)
        second = torch.tensor(start + step, dtype=t, device=dev).to(work)
        data = (first + torch.arange(n, device=dev).to(work) * (second - first)).to(t)
        data[:2] = torch.stack([first, second])[:n].to(t)
    return _from_global(data, split, device, comm, dtype)


def _like(a: DNDarray, dtype, split, device, comm):
    return (
        a.shape,
        a.dtype if dtype is None else dtype,
        a.split if split is None else split,
        a.device if device is None else device,
        a.comm if comm is None else comm,
    )


def zeros_like(a: DNDarray, dtype=None, split=None, device=None, comm=None) -> DNDarray:
    return zeros(*_like(a, dtype, split, device, comm))


def ones_like(a: DNDarray, dtype=None, split=None, device=None, comm=None) -> DNDarray:
    return ones(*_like(a, dtype, split, device, comm))


def empty_like(a: DNDarray, dtype=None, split=None, device=None, comm=None) -> DNDarray:
    return empty(*_like(a, dtype, split, device, comm))


def full_like(a: DNDarray, fill_value, dtype=types.float32, split=None, device=None, comm=None) -> DNDarray:
    shape, dt, sp, dev, cm = _like(a, dtype, split, device, comm)
    return full(shape, fill_value, dt, sp, dev, cm)


def eye(shape, dtype=types.float32, split=None, device=None, comm=None, order="C") -> DNDarray:
    """A 2-D array with ones on the diagonal (reference factories.py:408);
    each rank builds only its own chunk."""
    if isinstance(shape, (builtins.int, np.integer)):
        gshape = (builtins.int(shape), builtins.int(shape))
    else:
        shape = tuple(shape)
        gshape = (builtins.int(shape[0]), builtins.int(shape[1] if len(shape) > 1 else shape[0]))
    dtype = types.canonical_heat_type(dtype)
    device = sanitize_device(device)
    comm = sanitize_comm(comm)
    split = sanitize_axis(gshape, split)
    _, _, (rows, cols) = comm.chunk(gshape, split)
    dev = device.torch_device
    r = torch.arange(rows.start, rows.stop, device=dev)[:, None]
    c = torch.arange(cols.start, cols.stop, device=dev)[None, :]
    return DNDarray((r == c).to(dtype.torch_type()), gshape, dtype, split, device, comm, True)


def linspace(start, stop, num: int = 50, endpoint: bool = True, retstep: bool = False,
             dtype=None, split=None, device=None, comm=None):
    """``num`` evenly spaced samples over [start, stop] (reference
    factories.py:422): computed in float64 as ``jnp.linspace`` computes
    them (``start * (1 - i/div) + stop * i/div``, the end point appended),
    then float32 unless ``dtype`` is given."""
    num = builtins.int(num)
    if num <= 0:
        raise ValueError(f"number of samples 'num' must be non-negative integer, but was {num}")
    start, stop = builtins.float(start), builtins.float(stop)
    div = num - 1 if endpoint else num
    step = (stop - start) / builtins.max(1, div)
    device = sanitize_device(device)
    comm = sanitize_comm(comm)
    dev = device.torch_device
    if num > 1:
        frac = torch.arange(div, dtype=torch.float64, device=dev) / div
        data = start * (1 - frac) + stop * frac
        if endpoint:
            data = torch.cat([data, torch.tensor([stop], dtype=torch.float64, device=dev)])
    else:
        data = torch.tensor([start], dtype=torch.float64, device=dev)
    dt = types.float32 if dtype is None else types.canonical_heat_type(dtype)
    res = _from_global(data.to(dt.torch_type()), split, device, comm, dt)
    return (res, step) if retstep else res


def logspace(start, stop, num=50, endpoint=True, base=10.0, dtype=None, split=None, device=None,
             comm=None) -> DNDarray:
    """``num`` samples on a log scale, ``base ** linspace(start, stop)``
    (reference factories.py:454)."""
    from . import arithmetics

    y = linspace(start, stop, num=num, endpoint=endpoint, split=split, device=device, comm=comm)
    res = arithmetics.pow(builtins.float(base), y)
    return res if dtype is None else res.astype(types.canonical_heat_type(dtype))


def meshgrid(*arrays, indexing: str = "xy"):
    """Coordinate matrices from 1-D coordinate vectors (reference
    factories.py:467). The vectors are gathered; if one is split, every grid
    is split along the dimension that carries its coordinate."""
    if indexing not in ("xy", "ij"):
        raise ValueError(f"indexing must be 'xy' or 'ij', got {indexing}")
    if not arrays:
        return []
    hts = [a if isinstance(a, DNDarray) else array(a) for a in arrays]
    splits = [a.split for a in hts]
    if builtins.sum(s is not None for s in splits) > 1:
        raise ValueError("split axis can be defined for at most one input")
    which = next((i for i, s in enumerate(splits) if s is not None), None)
    out_split = None
    if which is not None:
        out_split = 1 - which if indexing == "xy" and which < 2 and len(hts) > 1 else which
    vecs = [a._global().reshape(-1) for a in hts]
    shape = [v.shape[0] for v in vecs]
    if indexing == "xy" and len(vecs) > 1:
        shape[0], shape[1] = shape[1], shape[0]
    grids = []
    for i, v in enumerate(vecs):
        dim = (1 - i if i < 2 else i) if indexing == "xy" and len(vecs) > 1 else i
        view = [1] * len(vecs)
        view[dim] = -1
        grids.append(v.reshape(view).expand(shape).contiguous())
    return [_from_global(g, out_split, hts[0].device, hts[0].comm) for g in grids]
