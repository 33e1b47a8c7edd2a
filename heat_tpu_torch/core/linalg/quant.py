"""Int8 quantised matmul (W8A8), the counterpart of ``heat_tpu/core/linalg/quant.py``.

* :func:`quantize_int8`: symmetric absmax int8 quantisation along an axis,
  in plain torch (as in the JAX package, where it is plain jnp). It is
  bit-equal to the JAX function: ``absmax / 127.0`` stays f32, an all-zero
  slice gets scale 1, and ``torch.round`` rounds half to even like
  ``jnp.round``.
* :func:`int8_matmul`: ``(qa @ qb) * (sa * sb)`` through the W8A8 GEMM
  kernel (:mod:`.cuda_quant`).
* :func:`matmul_int8`: quantise both float operands, then multiply.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .cuda_quant import int8_gemm

__all__ = ["quantize_int8", "int8_matmul", "matmul_int8"]

_OUT_DTYPES = (torch.float32, torch.bfloat16)


def quantize_int8(x: torch.Tensor, axis: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(q, scale)`` with ``q ≈ x / scale`` in int8 and ``scale``
    f32, shaped like ``x`` with ``axis`` reduced to size 1."""
    absmax = torch.amax(torch.abs(x), dim=axis, keepdim=True)
    scale = torch.where(absmax == 0, 1.0, absmax / 127.0).to(torch.float32)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_matmul(
    qa: torch.Tensor,
    sa: torch.Tensor,
    qb: torch.Tensor,
    sb: torch.Tensor,
    *,
    block_m: int = 512,
    block_n: int = 512,
    block_k: int = 512,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """``(qa @ qb) * (sa * sb)`` with int32 accumulation.

    ``qa``: (M, K) int8 with per-row scales ``sa`` (M, 1); ``qb``: (K, N)
    int8 with per-column scales ``sb`` (1, N). ``out_dtype`` is float32 or
    bfloat16. The ``block_*`` arguments are the JAX kernel's tiles and are
    accepted for its signature; the kernel here chooses its own."""
    if out_dtype not in _OUT_DTYPES:
        raise ValueError(f"out_dtype must be torch.float32 or torch.bfloat16, got {out_dtype}")
    m, k = qa.shape
    k2, n = qb.shape
    if k != k2:
        raise ValueError(f"contraction mismatch: {tuple(qa.shape)} @ {tuple(qb.shape)}")
    if m == 0 or n == 0 or k == 0:
        # the contract of a matmul: zeros (an empty contraction adds nothing)
        return torch.zeros((m, n), dtype=out_dtype, device=qa.device)
    return int8_gemm(qa, sa, qb, sb, out_dtype)


def matmul_int8(a: torch.Tensor, b: torch.Tensor, **kw) -> torch.Tensor:
    """W8A8 product of two float matrices: ``a`` quantised per row, ``b``
    per column."""
    qa, sa = quantize_int8(a, axis=1)
    qb, sb = quantize_int8(b, axis=0)
    return int8_matmul(qa, sa, qb, sb, **kw)
