"""Build and load the package's CUDA kernels, and count their launches.

Each source ``csrc/<name>.cu`` is compiled at first use by its own ``nvcc``
into ``build/heat_tpu_torch/lib<name>-<digest>.so`` beside the package
(the digest covers the source, every ``csrc/*.cuh`` header and the flags,
so an edited source or header builds anew), and loaded with ``ctypes``.
:func:`build` starts one ``nvcc`` per missing library, all at once. A
build that fails raises :class:`KernelBuildError`; nothing falls back.

Every C entry takes its pointers and the stream as ``c_void_p`` and returns
``cudaGetLastError()``; :func:`check` raises when that is not 0.

The launch counts are plain integers per kernel (``KERNELS``; a source
may hold several, as ``flash_bwd`` holds the three backward kernels),
incremented by each wrapper where it launches its kernel and nowhere else,
so that a run can show that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional

__all__ = [
    "KERNELS",
    "KernelBuildError",
    "SOURCES",
    "build",
    "check",
    "count_launch",
    "launch_counts",
    "library",
    "reset_launch_counts",
]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "heat_tpu_torch"
SOURCES = ("moments", "cdist", "lloyd", "flash_fwd", "int8_gemm", "flash_bwd", "random")
# the launch counters: one per kernel, named by source where it holds one
KERNELS = ("moments", "cdist", "lloyd", "flash_fwd", "int8_gemm",
           "flash_bwd_dq", "flash_bwd_dkv", "flash_bwd_fused", "random")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
_LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}


class KernelBuildError(RuntimeError):
    """A CUDA source did not compile or its library did not load."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise KernelBuildError("nvcc not found: the CUDA kernels need the CUDA toolkit to build")


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for part in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        h.update(part.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Compile every named source whose library is missing, one ``nvcc``
    each, all started together; returns the library paths. The compiler's
    output (register and shared-memory use per kernel) is kept beside each
    library as ``<library>.log``."""
    names = list(names)
    targets = {name: _target(name) for name in names}
    todo = [n for n in names if not targets[n].exists()]
    if not todo:
        return targets
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in todo:
        tmp = targets[name].with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        targets[name].with_suffix(".so.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, targets[name])
    if failed:
        raise KernelBuildError("CUDA build failed:\n" + "\n".join(failed))
    return targets


def library(name: str, signatures: Dict[str, list]) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed, with
    ``argtypes`` set from ``signatures`` (symbol → list of ctypes types)
    and ``restype`` ``c_int`` for each."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = build([name])[name]
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as e:
                raise KernelBuildError(f"cannot load {path}: {e}") from e
            for symbol, argtypes in signatures.items():
                fn = getattr(lib, symbol)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.heat_cuda_error_string.argtypes = [ctypes.c_int]
            lib.heat_cuda_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
        return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error."""
    if rc != 0:
        msg = lib.heat_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def count_launch(name: str) -> None:
    if name not in _LAUNCHES:
        raise KeyError(f"no launch counter for {name!r}; the kernels are {KERNELS}")
    _LAUNCHES[name] += 1


def launch_counts() -> Dict[str, int]:
    """Snapshot of the launch count of every kernel."""
    return dict(_LAUNCHES)


def reset_launch_counts(names: Optional[Iterable[str]] = None) -> None:
    for name in (KERNELS if names is None else names):
        _LAUNCHES[name] = 0
