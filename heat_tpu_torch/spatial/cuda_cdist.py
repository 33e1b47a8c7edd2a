"""Pairwise euclidean distances in GEMM form with a fused epilogue.

Counterpart of ``heat_tpu/spatial/pallas_cdist.py``. The kernels
(``csrc/cdist.cu``) replace ``_kernel`` there: for (m, k) x and (n, k) y
they write ``sqrt(max(|x|^2 + |y|^2 - 2 x.y, 0))`` (``epilogue="dist"``)
or ``exp(-gamma * d^2)`` (``"rbf"``) once into the (m, n) output, with the
norms and the epilogue computed on the tile.

The product's strategy is the JAX package's ``HEAT_TPU_CDIST_PREC``
(:func:`cdist_precision`: the same values, default, warning and reading at
call time), mapped onto this card's tensor cores:

========================  ==========================  ======================
value                     TPU meaning                 H100 kernel
========================  ==========================  ======================
``bf16x3`` (default),     three bf16 passes, or the   3xTF32 ``wgmma``
``high``                  HIGH tier                   (``cdist_tc``)
``default``               one bf16 pass               one TF32 ``wgmma`` pass
``highest``               exact f32                   f32 FMAs
                                                      (``cdist_fma_stream``)
========================  ==========================  ======================

The tensor-core kernel takes f32, k <= 512, k % 4 == 0 and 16-byte aligned
data (the bulk copies' rows). Any other shape runs the exact f32 FMA
kernel, as ``highest`` does: ``cdist_fma_stream``, which stores one tile
while it computes the next. The choice is by shape before the launch,
never after a failure. The variants, as :func:`last_variant` names the
one the last call ran (and a ``pallas_cdist`` span its ``variant``):

====================  ====================  ==========================================
variant               kernel                shapes
====================  ====================  ==========================================
``3xtf32_wgmma``      ``cdist_tc``          the tensor-core gate, ``bf16x3``/``high``
``tf32_wgmma``        ``cdist_tc``          the tensor-core gate, ``default``
``f32_fma_stream``    ``cdist_fma_stream``  off the gate, or ``highest``
``f32_fma``           ``cdist_kernel``      ``_old_kernel=True``; m or n past
                                            2^31 - 129 rows
====================  ====================  ==========================================

``cdist_kernel`` is the older f32 FMA tile kernel; ``cdist_fma_stream``
gives its bits at every k. At the main path's 16,384 x 16,384 x 128 the
3xTF32 kernel is bound by its tensor-core operations; at SUSY's k = 18 the
streamed kernel by its write. The source says how each design meets its
bound.

On a CPU tensor :func:`euclid` computes :func:`euclid_plain` in exact f32
whatever the strategy, as the JAX package off the TPU never reaches its
kernel. On a CUDA tensor it launches a kernel or raises.
:func:`euclid_plain` computes each strategy in plain torch (the TF32 forms
emulate the tensor cores: each operand with its low 13 mantissa bits
cleared); on a card it is the kernels' oracle and nothing else.
"""

from __future__ import annotations

import ctypes
import warnings
from typing import Optional

import torch

from .. import _build
from .. import _knobs as knobs
from .. import telemetry

__all__ = ["cdist_precision", "euclid", "euclid_plain", "last_variant", "pallas_cdist_applicable"]

_MAX_K = 512
_TILE = 128  # csrc/cdist.cu TC_BM, TC_BN
_PANEL = 32  # csrc/cdist.cu TC_PANEL
_MAX_ROWS = 2 ** 31 - 1 - _TILE

# the knob of heat_tpu/_knobs.py:234-241, read as the JAX package's
# pallas_cdist.py:55-77 reads it
_PREC_ENV = "HEAT_TPU_CDIST_PREC"
_PREC_VALUES = ("bf16x3", "default", "high", "highest")
# cdist_precision()'s answers -> the product each kernel or plain form computes
_TIERS = {"bf16x3": "3xtf32", "HIGH": "3xtf32", "DEFAULT": "tf32", "HIGHEST": "f32"}
_VARIANTS = {"3xtf32": "3xtf32_wgmma", "tf32": "tf32_wgmma", "f32": "f32_fma_stream"}

_SIGNATURES = {
    "heat_cdist_f32": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
    ],
    "heat_cdist_f32_stream": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
    ],
    "heat_cdist_tc": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ],
}

_LAST = {"variant": None}


def cdist_precision() -> str:
    """The product's strategy: ``"bf16x3"`` unless ``HEAT_TPU_CDIST_PREC``
    names one of ``bf16x3`` / ``default`` / ``high`` / ``highest`` (then
    ``"DEFAULT"``, ``"HIGH"`` or ``"HIGHEST"``). Read at call time; an
    unknown value warns and keeps ``"bf16x3"``."""
    v = (knobs.raw(_PREC_ENV, "") or "").strip().lower()
    if not v or v == "bf16x3":
        return "bf16x3"
    if v in _PREC_VALUES:
        return v.upper()
    warnings.warn(
        f"{_PREC_ENV}={v!r} is not one of {_PREC_VALUES}; "
        "keeping the bf16x3 default"
    )
    return "bf16x3"


def _tier(precision: Optional[str]) -> str:
    if precision is None:
        precision = cdist_precision()
    key = "bf16x3" if str(precision).lower() == "bf16x3" else str(precision).upper()
    if key not in _TIERS:
        raise ValueError(f"precision must be one of {_PREC_VALUES} or None, got {precision!r}")
    return _TIERS[key]


def _check_epilogue(epilogue: str) -> None:
    if epilogue not in ("dist", "rbf"):
        raise ValueError(f"epilogue must be 'dist' or 'rbf', got {epilogue!r}")


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b.T in full f32: TF32 is off for the product alone, and the
    caller's setting is restored after it, also when it raises."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return a @ b.T
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def _tf32(v: torch.Tensor) -> torch.Tensor:
    """The tensor cores' TF32 reading of f32 ``v``: its low 13 mantissa bits cleared."""
    return (v.view(torch.int32) & ~0x1FFF).view(torch.float32)


def euclid_plain(x: torch.Tensor, y: torch.Tensor, gamma: float = 0.0,
                 epilogue: str = "dist", precision: Optional[str] = "HIGHEST") -> torch.Tensor:
    """The kernels' function in plain torch. ``precision`` is a value of
    :func:`cdist_precision` (``None`` reads it): ``"HIGHEST"`` is the exact
    f32 product; ``"DEFAULT"`` one TF32 product and ``"bf16x3"``/``"HIGH"``
    3xTF32 (lo.hi + hi.lo + hi.hi of hi = tf32(v), lo = tf32(v - hi)), both
    emulated in f32 and only for f32 inputs. The norms are exact f32."""
    _check_epilogue(epilogue)
    tier = _tier(precision)
    x2 = (x * x).sum(dim=1, keepdim=True)
    y2 = (y * y).sum(dim=1, keepdim=True).T
    if tier == "f32" or x.dtype != torch.float32 or y.dtype != torch.float32:
        dot = _mm_f32(x, y)
    elif tier == "tf32":
        dot = _mm_f32(_tf32(x), _tf32(y))
    else:
        xh, yh = _tf32(x), _tf32(y)
        xl, yl = _tf32(x - xh), _tf32(y - yh)
        dot = (_mm_f32(xl, yh) + _mm_f32(xh, yl)) + _mm_f32(xh, yh)
    d2 = torch.clamp(x2 + y2 - 2.0 * dot, min=0.0)
    if epilogue == "rbf":
        return torch.exp(-gamma * d2)
    return torch.sqrt(d2)


def _variant(x: torch.Tensor, y: torch.Tensor, tier: str) -> str:
    """The kernel that runs for these (contiguous f32) operands, by shape
    alone: the tensor-core kernel inside its gate, else the FMA one (the
    tile kernel where m or n passes the streamed kernel's int32 rows)."""
    m, k = x.shape
    n = y.shape[0]
    if m > _MAX_ROWS or n > _MAX_ROWS:
        return "f32_fma"
    if (tier != "f32" and 4 <= k <= _MAX_K and k % 4 == 0
            and x.data_ptr() % 16 == 0 and y.data_ptr() % 16 == 0):
        return _VARIANTS[tier]
    return _VARIANTS["f32"]


def last_variant() -> Optional[str]:
    """The kernel the last :func:`euclid` call on a card ran:
    ``"3xtf32_wgmma"``, ``"tf32_wgmma"``, ``"f32_fma_stream"`` or
    ``"f32_fma"``."""
    return _LAST["variant"]


def euclid(x: torch.Tensor, y: torch.Tensor, gamma: float = 0.0, epilogue: str = "dist",
           precision: Optional[str] = None, _old_kernel: bool = False) -> torch.Tensor:
    """(m, n) distances (``"dist"``) or Gaussian kernel values (``"rbf"``)
    between the rows of (m, k) ``x`` and (n, k) ``y``. A kernel on the card
    (``precision``: a value of :func:`cdist_precision`, which ``None``
    reads), the exact plain version on the CPU. ``_old_kernel=True`` runs
    the older f32 FMA tile kernel (``cdist_kernel``) whatever the strategy
    and the shape, for comparisons.

    Where a span is wanted (``telemetry.spanning()``), a call on the card is
    a ``pallas_cdist`` span (the JAX package's name) whose ``bytes`` is the
    kernel's one obligatory write of the output and whose ``variant`` is
    :func:`last_variant`'s name of the kernel it ran; a call being captured into
    a CUDA graph is not instrumented, as the JAX package skips calls inside
    a trace."""
    _check_epilogue(epilogue)
    if x.ndim != 2 or y.ndim != 2 or x.shape[1] != y.shape[1]:
        raise ValueError(f"euclid needs (m, k) and (n, k) tensors, got {tuple(x.shape)}, {tuple(y.shape)}")
    if x.device != y.device:
        raise ValueError(f"x and y lie on different devices: {x.device}, {y.device}")
    if x.device.type == "cpu":
        return euclid_plain(x, y, gamma, epilogue)
    if x.dtype != torch.float32 or y.dtype != torch.float32:
        raise ValueError("cdist kernel needs float32 tensors")
    if telemetry.spanning() and not torch.cuda.is_current_stream_capturing():
        m, n = x.shape[0], y.shape[0]
        with telemetry.span("pallas_cdist", bytes=m * n * 4, gshape=[m, n], epilogue=epilogue,
                            hbm_write=True) as sp:
            out = _euclid_card(x, y, gamma, epilogue, precision, _old_kernel)
            sp.add_fields(variant=_LAST["variant"])
            return out
    return _euclid_card(x, y, gamma, epilogue, precision, _old_kernel)


def _euclid_card(x: torch.Tensor, y: torch.Tensor, gamma: float, epilogue: str,
                 precision: Optional[str], _old_kernel: bool) -> torch.Tensor:
    tier = "f32" if _old_kernel else _tier(precision)
    same = x is y or (x.data_ptr() == y.data_ptr() and x.shape == y.shape
                      and x.stride() == y.stride())
    x = x.contiguous()
    y = x if same else y.contiguous()
    m, k = x.shape
    n = y.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return out
    variant = "f32_fma" if _old_kernel else _variant(x, y, tier)
    lib = _build.library("cdist", _SIGNATURES)
    rbf = 1 if epilogue == "rbf" else 0
    with torch.cuda.device(x.device):  # launch on the tensor's card
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if variant == "f32_fma":
            rc = lib.heat_cdist_f32(x.data_ptr(), y.data_ptr(), out.data_ptr(), m, n, k, rbf,
                                    float(gamma), stream)
        elif variant == "f32_fma_stream":
            rc = lib.heat_cdist_f32_stream(x.data_ptr(), y.data_ptr(), out.data_ptr(), m, n, k,
                                           rbf, float(gamma), stream)
        else:
            split = variant == "3xtf32_wgmma"
            kp = -(-k // _PANEL) * _PANEL
            pad = lambda rows: -(-rows // _TILE) * _TILE  # noqa: E731
            yhi = torch.empty((n, kp), dtype=torch.float32, device=x.device)
            ylo = torch.empty((n, kp), dtype=torch.float32, device=x.device) if split else None
            yn = torch.empty((pad(n),), dtype=torch.float32, device=x.device)
            xn = yn if same else torch.empty((pad(m),), dtype=torch.float32, device=x.device)
            rc = lib.heat_cdist_tc(x.data_ptr(), y.data_ptr(), yhi.data_ptr(),
                                   ylo.data_ptr() if split else None, xn.data_ptr(),
                                   yn.data_ptr(), out.data_ptr(), m, n, k, int(same), rbf,
                                   float(gamma), int(split), stream)
    _build.check(lib, rc, f"cdist kernel ({variant})")
    _build.count_launch("cdist")
    _LAST["variant"] = variant
    return out


def pallas_cdist_applicable(k: int, dtype) -> bool:
    """The JAX package's gate for its cdist kernel without the backend test:
    f32 and k <= 512."""
    return k <= _MAX_K and dtype == torch.float32
