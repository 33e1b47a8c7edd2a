"""Host-side native code (C++ through ctypes): the CSV parser.

The port's copy of ``heat_tpu/native`` (its loader, :38-57 there, and
``fastcsv.cpp``): a memory-mapped, multithreaded CSV tokenizer and writer
behind :func:`heat_tpu_torch.core.io.load_csv`/``save_csv``. It is built at
first use with ``g++`` into ``build/heat_tpu_torch/libfastcsv-<digest>.so``
beside the package (the digest covers the source and the flags, so an
edited source builds anew; ``build/`` is not part of the repository) and
loaded with ``ctypes``. Without ``g++`` every function returns None or
False and the callers take numpy's parser, as in the JAX package.

:func:`native_calls` counts the parses and writes that the library did, so
that a run can show that its CSV path went through it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

import numpy as np

__all__ = ["csv_dims", "library_path", "native_available", "native_calls", "parse_csv",
           "parse_csv_range", "write_csv"]

_SRC = Path(__file__).resolve().parent / "fastcsv.cpp"
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False
_CALLS: Dict[str, int] = {"parse": 0, "write": 0}


def library_path() -> Path:
    from .._build import BUILD_DIR

    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(_FLAGS).encode())
    return BUILD_DIR / f"libfastcsv-{h.hexdigest()[:16]}.so"


def _build(target: Path) -> bool:
    """Compile ``fastcsv.cpp`` to ``target`` with g++; returns success. The
    library is written to a temporary name and renamed into place, so that
    a concurrent build never loads a half-written file."""
    target.parent.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    try:
        result = subprocess.run(["g++", *_FLAGS, str(_SRC), "-o", str(tmp)],
                                capture_output=True, timeout=120)
        if result.returncode != 0 or not tmp.exists():
            return False
        os.replace(tmp, target)
        return True
    except (OSError, subprocess.TimeoutExpired):
        return False
    finally:
        if tmp.exists():
            try:
                tmp.unlink()
            except OSError:
                pass


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        target = library_path()
        if not target.exists() and not _build(target):
            _build_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(target))
        except OSError:
            _build_failed = True
            return None
        lib.csv_dims.argtypes = [ctypes.c_char_p, ctypes.c_char, ctypes.c_long,
                                 ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_long)]
        lib.csv_dims.restype = ctypes.c_int
        lib.csv_parse.argtypes = [ctypes.c_char_p, ctypes.c_char, ctypes.c_long,
                                  ctypes.POINTER(ctypes.c_double), ctypes.c_long, ctypes.c_long]
        lib.csv_parse.restype = ctypes.c_int
        lib.csv_parse_range.argtypes = [ctypes.c_char_p, ctypes.c_char, ctypes.c_long,
                                        ctypes.c_long, ctypes.c_long,
                                        ctypes.POINTER(ctypes.c_double), ctypes.c_long]
        lib.csv_parse_range.restype = ctypes.c_int
        lib.csv_write.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_double),
                                  ctypes.c_long, ctypes.c_long, ctypes.c_char, ctypes.c_int]
        lib.csv_write.restype = ctypes.c_int
        _lib = lib
        return _lib


def _sep_byte(sep: str):
    raw = sep.encode("utf-8")
    return ctypes.c_char(raw) if len(raw) == 1 else None


def native_available() -> bool:
    """Whether the native library is (or can be built and) loaded."""
    return _load() is not None


def native_calls() -> Dict[str, int]:
    """How many parses and writes the native library did in this process."""
    return dict(_CALLS)


def csv_dims(path: str, sep: str = ",", header_lines: int = 0) -> Optional[tuple]:
    """(rows, cols) of a CSV by the native scanner; None without the
    library or for a separator of more than one byte."""
    lib, bsep = _load(), _sep_byte(sep)
    if lib is None or bsep is None:
        return None
    rows, cols = ctypes.c_long(), ctypes.c_long()
    rc = lib.csv_dims(os.fsencode(path), bsep, header_lines, ctypes.byref(rows),
                      ctypes.byref(cols))
    if rc != 0:
        raise OSError(f"fastcsv: cannot read {path!r} (rc={rc})")
    return rows.value, cols.value


def parse_csv(path: str, sep: str = ",", header_lines: int = 0) -> Optional[np.ndarray]:
    """A numeric CSV as a float64 (rows, cols) array; None without the
    library (the caller takes numpy's parser)."""
    dims = csv_dims(path, sep, header_lines)
    if dims is None:
        return None
    rows, cols = dims
    out = np.empty((rows, cols), dtype=np.float64)
    if out.size:
        rc = _lib.csv_parse(os.fsencode(path), _sep_byte(sep), header_lines,
                            out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), rows, cols)
        if rc != 0:
            raise OSError(f"fastcsv: parse failed for {path!r} (rc={rc})")
    _CALLS["parse"] += 1
    return out


def parse_csv_range(path: str, sep: str, header_lines: int, row_offset: int, row_count: int,
                    cols: int) -> Optional[np.ndarray]:
    """Rows ``[row_offset, row_offset + row_count)`` as a float64
    (row_count, cols) array: one rank's block. None without the library."""
    lib, bsep = _load(), _sep_byte(sep)
    if lib is None or bsep is None:
        return None
    out = np.empty((row_count, cols), dtype=np.float64)
    if out.size:
        rc = lib.csv_parse_range(os.fsencode(path), bsep, header_lines, row_offset, row_count,
                                 out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), cols)
        if rc != 0:
            raise OSError(f"fastcsv: range parse failed for {path!r} (rc={rc})")
    _CALLS["parse"] += 1
    return out


def write_csv(path: str, data: np.ndarray, sep: str = ",", append: bool = False) -> bool:
    """Write a 2-D float array as CSV (``%.17g``: a double round-trips bit
    for bit); False without the library (the caller takes
    ``numpy.savetxt``)."""
    lib, bsep = _load(), _sep_byte(sep)
    if lib is None or bsep is None:
        return False
    arr = np.ascontiguousarray(data, dtype=np.float64)
    if arr.ndim != 2:
        raise ValueError(f"write_csv needs 2-D data, got {arr.ndim}-D")
    rc = lib.csv_write(os.fsencode(path), arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                       arr.shape[0], arr.shape[1], bsep, 1 if append else 0)
    if rc != 0:
        raise OSError(f"fastcsv: write failed for {path!r} (rc={rc})")
    _CALLS["write"] += 1
    return True
