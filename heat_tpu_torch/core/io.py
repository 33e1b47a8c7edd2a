"""Parallel I/O: npy, CSV (through the native parser), HDF5 and NetCDF.

Counterpart of ``heat_tpu/core/io.py`` (reference heat/core/io.py:55-972).
The JAX package reads on one controller and shards; the port follows the
reference Heat instead: every rank reads only its own slab of the file, by
the chunk rule of ``communication.chunk``, and holds it as its chunk. An
``.npy`` file is memory-mapped (``np.load(mmap_mode="r")``), so a rank
touches only its slab's pages; the slab is copied out of the read-only map
before it becomes a tensor. HDF5 reads are h5py range reads.

``chunks=(start, stop)`` (``load_npy``, ``load_hdf5``) reads only that
half-open block of rows, each rank its own slab of it: the out-of-core read
of ``streaming.ChunkStream``. Out-of-range blocks raise rather than read
short.

Writes: one rank writes a replicated array; a split array is written slab
by slab in rank order, with a barrier between turns (no rank gathers the
global array), and a failure on one rank raises on every rank after the
ring (the error flags travel as a device tensor, which NCCL needs). A
fresh file written by one rank is written to a temporary name and renamed
into place.

HDF5 needs h5py and NetCDF netCDF4 or scipy (NetCDF-3 through
``scipy.io``); ``supports_hdf5``/``supports_netcdf`` say which, and the
calls raise without them, as in the JAX package. The orbax-backed
``save_checkpoint``/``load_checkpoint`` of the JAX package's ``io`` are not
ported: ``resilience.checkpoint`` is the port's checkpoint.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from . import types
from .communication import sanitize_comm
from .devices import sanitize_device
from .dndarray import DNDarray
from .stride_tricks import sanitize_axis

__all__ = [
    "dataset_shape",
    "load",
    "load_csv",
    "load_npy",
    "save",
    "save_csv",
    "save_npy",
    "supports_hdf5",
    "supports_netcdf",
]

try:  # pragma: no cover - depends on the installation
    import h5py

    _HAS_H5 = True
except ImportError:
    h5py = None
    _HAS_H5 = False

try:  # pragma: no cover
    import netCDF4

    _HAS_NC4 = True
except ImportError:
    netCDF4 = None
    _HAS_NC4 = False

try:  # pragma: no cover - the NetCDF-3 backend when netCDF4 is absent
    from scipy.io import netcdf_file as _scipy_netcdf

    _HAS_NC_SCIPY = True
except ImportError:
    _scipy_netcdf = None
    _HAS_NC_SCIPY = False


class _NcRead:
    """Read adapter over the available NetCDF backend: netCDF4, else
    scipy.io (classic NetCDF-3), else h5py (a NetCDF-4 file is an HDF5
    file). Variables have ``.shape`` and numpy-yielding indexing."""

    def __init__(self, path: str):
        if _HAS_NC4:
            self._h = netCDF4.Dataset(path, "r")
            self._get = lambda name: self._h[name]
        elif _HAS_NC_SCIPY:
            try:
                self._h = _scipy_netcdf(path, "r", mmap=False)
                self._get = lambda name: self._h.variables[name]
            except Exception:
                if not _HAS_H5:
                    raise
                self._h = h5py.File(path, "r")
                self._get = lambda name: self._h[name]
        else:  # pragma: no cover - supports_netcdf() gates the callers
            raise RuntimeError("netcdf is required for this operation "
                               "(neither netCDF4 nor scipy is available)")

    def var(self, name: str):
        return self._get(name)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._h.close()
        return False


class _NcWrite:
    """Write adapter: netCDF4, else scipy.io NetCDF-3 (classic types only).
    ``mode`` as netCDF4's: ``'w'`` creates, ``'r+'`` modifies."""

    def __init__(self, path: str, mode: str):
        if _HAS_NC4:
            self._h = netCDF4.Dataset(path, mode)
        elif _HAS_NC_SCIPY:
            self._h = _scipy_netcdf(path, "w" if mode == "w" else "a", mmap=False)
        else:  # pragma: no cover
            raise RuntimeError("netcdf is required for this operation "
                               "(neither netCDF4 nor scipy is available)")

    def create(self, variable: str, dtype, shape):
        dims = []
        for i, s in enumerate(shape):
            name = f"{variable}_dim{i}"
            self._h.createDimension(name, int(s))
            dims.append(name)
        return self._h.createVariable(variable, dtype, tuple(dims))

    def var(self, name: str):
        return self._h[name] if _HAS_NC4 else self._h.variables[name]

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._h.close()
        return False


def supports_hdf5() -> bool:
    """Whether h5py is available (reference io.py ``supports_hdf5``)."""
    return _HAS_H5


def supports_netcdf() -> bool:
    """Whether a NetCDF backend is available: netCDF4, or scipy's NetCDF-3."""
    return _HAS_NC4 or _HAS_NC_SCIPY


def _need_hdf5() -> None:
    if not _HAS_H5:
        raise RuntimeError("hdf5 is required for this operation (h5py not available)")


def _need_netcdf() -> None:
    if not supports_netcdf():
        raise RuntimeError("netcdf is required for this operation "
                           "(neither netCDF4 nor scipy is available)")


def _atomic_write(path: str, write_fn) -> None:
    """``write_fn(tmp)`` on a sibling temporary path, then an atomic rename
    over ``path``: a failure leaves the previous file and no debris."""
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        write_fn(tmp)
        os.replace(tmp, path)
    except BaseException:
        try:
            if os.path.exists(tmp):
                os.remove(tmp)
        except OSError:
            pass
        raise


# -- reads ------------------------------------------------------------------


def _check_chunks(chunks, nrows: int, path: str) -> tuple:
    """The ``(start, stop)`` of a ``chunks=`` row range, validated against
    the file's ``nrows``."""
    try:
        start, stop = (int(chunks[0]), int(chunks[1]))
        if len(chunks) != 2:
            raise TypeError
    except (TypeError, ValueError, IndexError):
        raise TypeError(f"chunks must be a (start, stop) row-range pair, got {chunks!r}") from None
    if start < 0 or stop < 0:
        raise ValueError(f"chunks=({start}, {stop}): negative row indices are not "
                         f"supported for chunked reads")
    if start >= stop:
        raise ValueError(f"chunks=({start}, {stop}) is an empty row range: a chunked "
                         f"read needs start < stop")
    if stop > nrows:
        raise ValueError(f"chunks=({start}, {stop}) is a truncated final chunk: {path!r} has "
                         f"only {nrows} rows; clamp stop to the row count (ChunkStream does "
                         f"this for you)")
    return start, stop


def _wrap_local(block: np.ndarray, gshape, split, dtype, device, comm) -> DNDarray:
    """This rank's block (a fresh host array) as its chunk of a DNDarray of
    global shape ``gshape``; a type cast happens on the host, before the
    copy to the device."""
    device = sanitize_device(device)
    t = torch.from_numpy(block.astype(block.dtype.newbyteorder("="), copy=False))
    if dtype is not None:
        dtype = types.canonical_heat_type(dtype)
        t = t.to(dtype.torch_type())
    else:
        dtype = types.canonical_heat_type(t.dtype)
    t = t.to(device.torch_device)
    return DNDarray(t, tuple(gshape), dtype, split, device, comm, True)


def _read_slab(source, shape, split, comm, start: int = 0, stop: Optional[int] = None):
    """This rank's slab of rows ``[start, stop)`` of an indexable ``source``
    (a memory map, an h5py dataset, a NetCDF variable) of ``shape``, as a
    fresh host array, and the global shape of the block."""
    shape = tuple(int(s) for s in shape)
    stop = shape[0] if stop is None and shape else stop
    gshape = ((stop - start),) + shape[1:] if shape else ()
    split = sanitize_axis(gshape, split)
    _, _, slices = comm.chunk(gshape, split)
    if gshape:
        slices = (slice(start + slices[0].start, start + slices[0].stop),) + tuple(slices[1:])
    return np.array(source[slices] if gshape else source[()]), gshape, split


def dataset_shape(path: str, dataset: Optional[str] = None) -> tuple:
    """The on-disk shape of an array file without reading its data: the
    ``.npy`` header (a memory map) or the HDF5 dataset's metadata."""
    if dataset is not None or path.endswith((".h5", ".hdf5")):
        _need_hdf5()
        if dataset is None:
            raise ValueError(f"dataset_shape({path!r}) needs dataset= for HDF5 files")
        with h5py.File(path, "r") as handle:
            return tuple(handle[dataset].shape)
    try:
        data = np.load(path, mmap_mode="r", allow_pickle=False)
    except (ValueError, OSError, EOFError) as e:
        raise ValueError(f"dataset_shape: {path!r} is not a readable .npy array file ({e})") \
            from None
    return tuple(data.shape)


def load(path: str, *args, **kwargs) -> DNDarray:
    """Load by file extension (reference io.py:659)."""
    if not isinstance(path, str):
        raise TypeError(f"Expected path to be str, but was {type(path)}")
    ext = os.path.splitext(path)[-1]
    if ext in (".h5", ".hdf5"):
        return load_hdf5(path, *args, **kwargs)
    if ext in (".nc", ".netcdf"):
        return load_netcdf(path, *args, **kwargs)
    if ext == ".csv":
        return load_csv(path, *args, **kwargs)
    if ext == ".npy":
        return load_npy(path, *args, **kwargs)
    raise ValueError(f"Unsupported file extension {ext}")


def load_npy(path: str, dtype=None, split=None, device=None, comm=None, chunks=None) -> DNDarray:
    """Load a ``.npy`` file: each rank copies its slab out of a memory map.
    ``chunks=(start, stop)`` reads only that block of rows."""
    comm = sanitize_comm(comm)
    try:
        data = np.load(path, mmap_mode="r", allow_pickle=False)
    except (ValueError, OSError, EOFError) as e:
        raise ValueError(f"load_npy: {path!r} is not a readable .npy array file ({e})") from None
    if data.dtype == object or data.dtype.hasobject:
        raise ValueError(f"load_npy: {path!r} holds dtype=object data, which has no DNDarray "
                         "representation; save numeric arrays only")
    start, stop = 0, None
    if chunks is not None:
        if data.ndim == 0:
            raise ValueError(f"load_npy: {path!r} is 0-d; chunked reads need a row axis")
        start, stop = _check_chunks(chunks, data.shape[0], path)
    block, gshape, split = _read_slab(data, data.shape, split, comm, start, stop)
    return _wrap_local(block, gshape, split, dtype, device, comm)


def load_csv(path: str, header_lines: int = 0, sep: str = ",", dtype=types.float32,
             encoding: str = "utf-8", split: Optional[int] = None, device=None,
             comm=None) -> DNDarray:
    """Load a numeric CSV file through the native multithreaded parser
    (numpy's ``genfromtxt`` without it, or for other encodings). Row-split
    across ranks, each rank parses only its own rows (``csv_parse_range``:
    only the newline scan touches the whole file), the reference's
    per-rank byte ranges (io.py:710)."""
    if not isinstance(path, str):
        raise TypeError(f"Expected path to be str, but was {type(path)}")
    if not isinstance(sep, str):
        raise TypeError(f"Expected sep to be str, but was {type(sep)}")
    if not isinstance(header_lines, int):
        raise TypeError(f"Expected header_lines to be int, but was {type(header_lines)}")
    from .. import native

    comm = sanitize_comm(comm)
    plain_bytes = encoding.replace("-", "").lower() in ("utf8", "ascii")

    def genfromtxt_2d():
        """numpy's read as (rows, cols): genfromtxt collapses a single row
        or column to 1-D and one value to 0-D."""
        data = np.genfromtxt(path, delimiter=sep, skip_header=header_lines, encoding=encoding)
        if data.ndim < 2:
            with open(path, "r", encoding=encoding) as f:
                for _ in range(header_lines):
                    f.readline()
                line = f.readline().strip()
            data = data.reshape(-1, len(line.split(sep)) if line else 1)
        return data

    if comm.size > 1 and split == 0 and plain_bytes:
        dims = native.csv_dims(path, sep, header_lines)
        if dims is not None:
            rows, cols = dims
            offset, lshape, _ = comm.chunk((rows, cols), 0)
            block = native.parse_csv_range(path, sep, header_lines, offset, lshape[0], cols)
            return _wrap_local(block, (rows, cols), 0, dtype, device, comm)
    data = native.parse_csv(path, sep=sep, header_lines=header_lines) if plain_bytes else None
    if data is None:
        data = genfromtxt_2d()
    block, gshape, split = _read_slab(data, data.shape, split, comm)
    return _wrap_local(block, gshape, split, dtype, device, comm)


def load_hdf5(path: str, dataset: str, dtype=types.float32, split: Optional[int] = None,
              device=None, comm=None, chunks=None) -> DNDarray:
    """Load an HDF5 dataset, each rank reading its own slab (reference
    io.py:55's ``f[dataset][slices]``). ``chunks=(start, stop)`` reads only
    that block of rows (the reference's ``PartialH5Dataset`` access)."""
    _need_hdf5()
    if not isinstance(path, str):
        raise TypeError(f"path must be str, not {type(path)}")
    if not isinstance(dataset, str):
        raise TypeError(f"dataset must be str, not {type(dataset)}")
    comm = sanitize_comm(comm)
    with h5py.File(path, "r") as handle:
        ds = handle[dataset]
        start, stop = 0, None
        if chunks is not None:
            if len(ds.shape) == 0:
                raise ValueError(f"load_hdf5: {path!r}:{dataset} is 0-d; chunked reads need "
                                 "a row axis")
            start, stop = _check_chunks(chunks, ds.shape[0], path)
        block, gshape, split = _read_slab(ds, ds.shape, split, comm, start, stop)
    return _wrap_local(block, gshape, split, dtype, device, comm)


def load_netcdf(path: str, variable: str, dtype=types.float32, split: Optional[int] = None,
                device=None, comm=None) -> DNDarray:
    """Load a NetCDF variable, each rank reading its own slab (reference
    io.py:265)."""
    _need_netcdf()
    comm = sanitize_comm(comm)
    with _NcRead(path) as handle:
        var = handle.var(variable)
        block, gshape, split = _read_slab(var, var.shape, split, comm)
    return _wrap_local(block, gshape, split, dtype, device, comm)


# -- writes -----------------------------------------------------------------


def _host(x: DNDarray) -> np.ndarray:
    """This rank's data on the host."""
    return x.larray.detach().cpu().numpy()


def _local_block(x: DNDarray):
    """This rank's data of a split DNDarray on the host, and its global
    bounds ``(block, lo, hi)`` along the split axis."""
    offset, lshape, _ = x.comm.chunk(x.shape, x.split)
    return _host(x), offset, offset + lshape[x.split]


def _serialized_slab_write(x: DNDarray, writer) -> None:
    """``writer(rank)`` on each rank in rank order, a barrier between turns
    (concurrent writes to one file are unsafe without MPI-IO). A failure is
    held until the ring ends; then every rank learns every rank's flag,
    exchanged as a tensor on the array's device, and all raise."""
    comm = x.comm
    err = None
    for p in range(comm.size):
        if p == comm.rank and err is None:
            try:
                writer(p)
            except Exception as e:  # noqa: BLE001 - raised after the ring
                err = e
        comm.barrier()
    flag = torch.tensor([0 if err is None else 1], dtype=torch.int32, device=x.larray.device)
    flags = comm.allgather(flag, 0, comm.size).cpu().numpy()
    if err is not None:
        raise err
    if flags.any():
        raise RuntimeError(f"slab write failed on rank(s) {np.nonzero(flags)[0].tolist()}: "
                                 "the file is incomplete")


def _one_writer(x: DNDarray, write0) -> None:
    """Rank 0 writes (a replicated array, or a world of one); every rank
    raises if it failed."""
    _serialized_slab_write(x, lambda p: write0() if p == 0 else None)


def save(data: DNDarray, path: str, *args, **kwargs):
    """Save by file extension (reference io.py:923)."""
    if not isinstance(data, DNDarray):
        raise TypeError(f"Expected data to be DNDarray, but was {type(data)}")
    if not isinstance(path, str):
        raise TypeError(f"Expected path to be str, but was {type(path)}")
    ext = os.path.splitext(path)[-1]
    if ext in (".h5", ".hdf5"):
        return save_hdf5(data, path, *args, **kwargs)
    if ext in (".nc", ".netcdf"):
        return save_netcdf(data, path, *args, **kwargs)
    if ext == ".csv":
        return save_csv(data, path, *args, **kwargs)
    if ext == ".npy":
        return save_npy(data, path)
    raise ValueError(f"Unsupported file extension {ext}")


def save_npy(data: DNDarray, path: str) -> None:
    """Save to ``.npy``. A split array across ranks: rank 0 creates the file
    at the global shape through a memory map, then each rank writes only its
    slab, in rank order."""
    if data.comm.size > 1 and data.split is not None:
        block, lo, hi = _local_block(data)
        sl = [slice(None)] * data.ndim
        sl[data.split] = slice(lo, hi)

        def write(p):
            mm = np.lib.format.open_memmap(path, mode="w+" if p == 0 else "r+",
                                           dtype=block.dtype if p == 0 else None,
                                           shape=tuple(data.shape) if p == 0 else None)
            if hi > lo:
                mm[tuple(sl)] = block
            mm.flush()
            del mm

        _serialized_slab_write(data, write)
        return
    def write_npy(tmp):
        # np.save(path) would add ".npy" to the temporary name
        with open(tmp, "wb") as f:
            np.save(f, _host(data))

    _one_writer(data, lambda: _atomic_write(path, write_npy))


def save_csv(data: DNDarray, path: str, header_lines: Optional[str] = None, sep: str = ","):
    """Save to CSV (reference io.py ``save_csv``) through the native writer
    (``%.17g``), numpy's ``savetxt`` without it. Row-split across ranks:
    rank 0 truncates the file and writes the header and its rows, the
    others append theirs in rank order; no rank gathers the array.
    Replicated arrays are written by rank 0; a column split across ranks
    raises (``resplit_(0)`` first)."""
    from .. import native

    def header_text():
        if not header_lines:
            return ""
        return "".join("# " + ln + "\n" for ln in str(header_lines).splitlines())

    if data.comm.size > 1 and data.split == 0:
        block, lo, hi = _local_block(data)

        def write(p):
            if p == 0:
                with open(path, "w") as f:
                    f.write(header_text())
            if hi > lo:
                blk2 = block if block.ndim == 2 else block[:, None]
                if not native.write_csv(path, blk2, sep=sep, append=True):
                    with open(path, "a") as f:
                        np.savetxt(f, block, delimiter=sep)

        _serialized_slab_write(data, write)
        return
    if data.comm.size > 1 and data.split is not None:
        raise NotImplementedError("save_csv across ranks supports split=0 (row-split) or "
                                  "replicated arrays only; resplit_(0) first")
    def write(tmp):
        host = _host(data)
        if host.ndim in (1, 2) and np.issubdtype(host.dtype, np.floating):
            h2 = host if host.ndim == 2 else host[:, None]
            with open(tmp, "w") as f:
                f.write(header_text())
            if native.write_csv(tmp, h2, sep=sep, append=True):
                return
        np.savetxt(tmp, host, delimiter=sep, header=header_lines or "")

    _one_writer(data, lambda: _atomic_write(path, write))


def save_hdf5(data: DNDarray, path: str, dataset: str, mode: str = "w", **kwargs):
    """Save to an HDF5 dataset (reference io.py:147). A split array across
    ranks: rank 0 creates the dataset at the global shape, then each rank
    writes its slab, in rank order."""
    _need_hdf5()
    if data.comm.size > 1 and data.split is not None:
        block, lo, hi = _local_block(data)
        sl = [slice(None)] * data.ndim
        sl[data.split] = slice(lo, hi)

        def write(p):
            with h5py.File(path, mode if p == 0 else "r+") as handle:
                if p == 0:
                    handle.create_dataset(dataset, shape=tuple(data.shape), dtype=block.dtype,
                                          **kwargs)
                if hi > lo:
                    handle[dataset][tuple(sl)] = block

        _serialized_slab_write(data, write)
        return
    def write_to(target, how):
        with h5py.File(target, how) as handle:
            handle.create_dataset(dataset, data=_host(data), **kwargs)

    if mode == "w":  # a fresh file is written atomically; "a"/"r+" edit in place
        _one_writer(data, lambda: _atomic_write(path, lambda tmp: write_to(tmp, "w")))
    else:
        _one_writer(data, lambda: write_to(path, mode))


def save_netcdf(data: DNDarray, path: str, variable: str, mode: str = "w", **kwargs):
    """Save to a NetCDF variable (reference io.py:348). A split array across
    ranks: rank 0 creates the dimensions and the variable at the global
    shape, then each rank writes its slab, in rank order."""
    _need_netcdf()
    if data.comm.size > 1 and data.split is not None:
        block, lo, hi = _local_block(data)
        sl = [slice(None)] * data.ndim
        sl[data.split] = slice(lo, hi)

        def write(p):
            with _NcWrite(path, mode if p == 0 else "r+") as handle:
                if p == 0:
                    handle.create(variable, block.dtype, tuple(data.shape))
                if hi > lo:
                    handle.var(variable)[tuple(sl)] = block

        _serialized_slab_write(data, write)
        return
    def write_to(target):
        host = _host(data)
        with _NcWrite(target, mode) as handle:
            var = handle.create(variable, host.dtype, host.shape)
            var[:] = host

    if mode == "w":
        _one_writer(data, lambda: _atomic_write(path, write_to))
    else:
        _one_writer(data, lambda: write_to(path))


if _HAS_H5:
    __all__ += ["load_hdf5", "save_hdf5"]
if supports_netcdf():
    __all__ += ["load_netcdf", "save_netcdf"]
