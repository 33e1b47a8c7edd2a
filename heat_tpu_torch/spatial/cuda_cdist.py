"""Pairwise euclidean distances in GEMM form with a fused epilogue.

Counterpart of ``heat_tpu/spatial/pallas_cdist.py``. The kernel
(``csrc/cdist.cu``) replaces ``_kernel`` there: for (m, k) x and (n, k) y it
writes ``sqrt(max(|x|^2 + |y|^2 - 2 x.y, 0))`` (``epilogue="dist"``) or
``exp(-gamma * d^2)`` (``"rbf"``) once into the (m, n) output, with the
norms and the epilogue computed on the tile. At k = 128 it is bound by the
FMA operations over the card's f32 rate; the source says how its design
meets that. Its products are exact f32 FMAs; the JAX package's bf16x3 and
precision switch are not ported yet.

On a CPU tensor :func:`euclid` computes :func:`euclid_plain`, the same
function in plain torch, which is also the kernel's oracle. On a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

__all__ = ["euclid", "euclid_plain", "pallas_cdist_applicable"]

_MAX_K = 512

_SIGNATURES = {
    "heat_cdist_f32": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
    ],
}


def _check_epilogue(epilogue: str) -> None:
    if epilogue not in ("dist", "rbf"):
        raise ValueError(f"epilogue must be 'dist' or 'rbf', got {epilogue!r}")


def euclid_plain(x: torch.Tensor, y: torch.Tensor, gamma: float = 0.0,
                 epilogue: str = "dist") -> torch.Tensor:
    """The kernel's function in plain torch (f32 product, no TF32)."""
    _check_epilogue(epilogue)
    x2 = (x * x).sum(dim=1, keepdim=True)
    y2 = (y * y).sum(dim=1, keepdim=True).T
    d2 = torch.clamp(x2 + y2 - 2.0 * (x @ y.T), min=0.0)
    if epilogue == "rbf":
        return torch.exp(-gamma * d2)
    return torch.sqrt(d2)


def euclid(x: torch.Tensor, y: torch.Tensor, gamma: float = 0.0,
           epilogue: str = "dist") -> torch.Tensor:
    """(m, n) distances (``"dist"``) or Gaussian kernel values (``"rbf"``)
    between the rows of (m, k) ``x`` and (n, k) ``y``. The kernel on the
    card, the plain version on the CPU."""
    _check_epilogue(epilogue)
    if x.ndim != 2 or y.ndim != 2 or x.shape[1] != y.shape[1]:
        raise ValueError(f"euclid needs (m, k) and (n, k) tensors, got {tuple(x.shape)}, {tuple(y.shape)}")
    if x.device != y.device:
        raise ValueError(f"x and y lie on different devices: {x.device}, {y.device}")
    if x.device.type == "cpu":
        return euclid_plain(x, y, gamma, epilogue)
    if x.dtype != torch.float32 or y.dtype != torch.float32:
        raise ValueError("cdist kernel needs float32 tensors")
    x, y = x.contiguous(), y.contiguous()
    m, k = x.shape
    n = y.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return out
    lib = _build.library("cdist", _SIGNATURES)
    with torch.cuda.device(x.device):  # launch on the tensor's card
        rc = lib.heat_cdist_f32(x.data_ptr(), y.data_ptr(), out.data_ptr(), m, n, k,
                                1 if epilogue == "rbf" else 0, float(gamma),
                                torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, rc, "cdist kernel")
    _build.count_launch("cdist")
    return out


def pallas_cdist_applicable(k: int, dtype) -> bool:
    """The JAX package's gate for its cdist kernel without the backend test:
    f32 and k <= 512."""
    return k <= _MAX_K and dtype == torch.float32
