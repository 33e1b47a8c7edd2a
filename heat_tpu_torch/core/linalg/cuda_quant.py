"""The W8A8 GEMM kernel and its plain version.

Counterpart of the ``pallas_call`` in ``heat_tpu/core/linalg/quant.py``.
The kernel (``csrc/int8_gemm.cu``) replaces ``_q_kernel`` there: (M, K)
int8 times (K, N) int8 with exact int32 accumulation, then
``f32(acc) * (sa * sb)`` cast to the output dtype. Its tiles are its own;
the JAX call's ``block_m``/``block_n``/``block_k`` do not reach it.

The result is exact up to the epilogue's roundings, which both versions
make in the same order, so the kernel is bit-identical to
:func:`int8_gemm_plain`. On a CPU tensor :func:`int8_gemm` computes the
plain version; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from ... import _build

__all__ = ["int8_gemm", "int8_gemm_plain"]

_SIGNATURES = {
    "heat_int8_gemm": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ],
}
_MAX_ROWS = 65535 * 128
_I32_MAX = 2 ** 31 - 1


def int8_gemm_plain(qa: torch.Tensor, sa: torch.Tensor, qb: torch.Tensor, sb: torch.Tensor,
                    out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The kernel's function in plain torch. The accumulation is exact: an
    int32 product on the CPU; on the card, where torch has no integer
    matmul, a float64 product (exact while 127^2 * K < 2^53)."""
    if qa.device.type == "cpu":
        acc = torch.matmul(qa.to(torch.int32), qb.to(torch.int32))
    else:
        acc = torch.matmul(qa.double(), qb.double()).to(torch.int32)
    scale = sa.float() * sb.float()  # (M, 1) * (1, N)
    return (acc.float() * scale).to(out_dtype)


def int8_gemm(qa: torch.Tensor, sa: torch.Tensor, qb: torch.Tensor, sb: torch.Tensor,
              out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``f32(qa @ qb) * (sa * sb)`` in ``out_dtype`` for non-empty (M, K)
    and (K, N) int8 operands, sa (M, 1) and sb (1, N) f32: the kernel on the
    card, the plain version on the CPU."""
    if not (qa.device == qb.device == sa.device == sb.device):
        raise ValueError("int8_gemm operands lie on different devices")
    if qa.device.type == "cpu":
        return int8_gemm_plain(qa, sa, qb, sb, out_dtype)
    m, k = qa.shape
    n = qb.shape[1]
    if qa.dtype != torch.int8 or qb.dtype != torch.int8:
        raise ValueError(f"int8 kernel needs int8 operands, got {qa.dtype}, {qb.dtype}")
    if sa.dtype != torch.float32 or sb.dtype != torch.float32:
        raise ValueError(f"int8 kernel needs float32 scales, got {sa.dtype}, {sb.dtype}")
    if sa.numel() != m or sb.numel() != n:
        raise ValueError(f"scales {tuple(sa.shape)}, {tuple(sb.shape)} do not fit ({m}, {n})")
    if m > _MAX_ROWS or max(n, k) > _I32_MAX:
        raise ValueError(f"int8 kernel: ({m}, {k}) @ ({k}, {n}) is past its limits")
    qa, qb, sa, sb = (x.contiguous() for x in (qa, qb, sa, sb))
    out = torch.empty((m, n), dtype=out_dtype, device=qa.device)
    lib = _build.library("int8_gemm", _SIGNATURES)
    with torch.cuda.device(qa.device):
        rc = lib.heat_int8_gemm(qa.data_ptr(), qb.data_ptr(), sa.data_ptr(), sb.data_ptr(),
                                out.data_ptr(), m, n, k, int(out_dtype == torch.bfloat16),
                                torch.cuda.current_stream(qa.device).cuda_stream)
    _build.check(lib, rc, "int8_gemm kernel")
    _build.count_launch("int8_gemm")
    return out
