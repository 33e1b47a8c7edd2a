"""The random draw on the card: counter-mode threefry2x32 in one kernel.

The kernel (``csrc/random.cu``) computes the four raw draws of
:mod:`._threefry` (``bits32``, ``bits64``, ``uniform_f32``, ``normal_f32``)
for a rank's :class:`~._threefry.Slice` of a global shape, one element a
thread, writing each output once. It replaces XLA's fused ``threefry2x32``
operation, which the JAX package reaches from ``core/random.py:59-65``
through ``jax.random``; the JAX package has no Pallas kernel for it. In
plain torch the same draw is well over a hundred launches of int32
additions, shifts and xors, each over the whole array.

:func:`draw` takes the plain version (:func:`._threefry.draw_plain`, also
the kernel's oracle) for a CPU device and launches the kernel for a CUDA
device, or raises. The transforms of other types (float64, float16,
bfloat16, the integer offsets of ``randint``, the sort keys of
``permutation``) are torch operations on the kernel's ``bits32`` and
``bits64`` output: a stated rule, not a fallback.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ._threefry import EPILOGUES, NORMAL_LO_F32, SQRT2_F32, Key, Slice, draw_plain

__all__ = ["draw"]

_THREADS = 256  # csrc/random.cu kThreads
_BLOCKS_PER_SM = 8  # one full wave of 256-thread blocks; the loop strides over the rest
_OUT = {"bits32": torch.int32, "bits64": torch.int64, "uniform_f32": torch.float32,
        "normal_f32": torch.float32}
_SIGNATURES = {
    "heat_threefry_draw": [
        ctypes.c_uint, ctypes.c_uint, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ],
}


def draw(key: Key, sl: Slice, epilogue: str, lo: float = 0.0, hi: float = 1.0,
         device="cpu") -> torch.Tensor:
    """The raw draw ``epilogue`` of ``sl`` under ``key`` on ``device``: the
    plain version on the CPU, the kernel on a card (see
    :func:`._threefry.draw_plain` for the four draws)."""
    device = torch.device(device)
    if device.type == "cpu":
        return draw_plain(key, sl, epilogue, lo, hi, device)
    if device.type != "cuda":
        raise ValueError(f"random draw: no kernel for device {device}")
    if epilogue not in EPILOGUES:
        raise ValueError(f"unknown epilogue {epilogue!r}; one of {EPILOGUES}")
    if epilogue == "normal_f32":
        lo, hi = NORMAL_LO_F32, 1.0
    out = torch.empty(sl.shape, dtype=_OUT[epilogue], device=device)
    n = out.numel()
    if n == 0:
        return out
    outer, g, inner, start, length = sl.layout()
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    blocks = max(1, min(-(-n // _THREADS), sms * _BLOCKS_PER_SM))
    lib = _build.library("random", _SIGNATURES)
    with torch.cuda.device(device):
        rc = lib.heat_threefry_draw(
            key[0], key[1], outer, g, inner, start, length, lo, hi, SQRT2_F32,
            EPILOGUES.index(epilogue), blocks, out.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream)
    _build.check(lib, rc, "random kernel")
    _build.count_launch("random")
    return out
