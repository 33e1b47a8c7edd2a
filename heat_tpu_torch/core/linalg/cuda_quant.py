"""The W8A8 GEMM kernel and its plain version.

Counterpart of the ``pallas_call`` in ``heat_tpu/core/linalg/quant.py``.
The kernel (``csrc/int8_gemm.cu``) replaces ``_q_kernel`` there: (M, K)
int8 times (K, N) int8 with exact int32 accumulation, then
``f32(acc) * (sa * sb)`` cast to the output dtype. Its tiles are its own;
the JAX call's ``block_m``/``block_n``/``block_k`` do not reach it.

Two kernels, chosen by shape: where K % 16 == 0 and qa's data is 16-byte
aligned (the bulk tensor copies need 16-byte rows), ``int8_gemm_wgmma``
(int8 ``wgmma`` fed by bulk tensor copies, after a pre-pass that writes
qb^T into a scratch buffer allocated here each call; its tile width
follows K, :func:`_wgmma_tile_width`); elsewhere the
``mma.sync`` kernel. ``_old_kernel=True`` forces the ``mma.sync`` kernel at
any shape, for comparisons.

The result is exact up to the epilogue's roundings, which every version
makes in the same order, so each kernel is bit-identical to
:func:`int8_gemm_plain`. The int32 accumulator is exact while
128^2 * K < 2^31; a longer K raises. On a CPU tensor :func:`int8_gemm`
computes the plain version; on a CUDA tensor it launches a kernel or
raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ... import _build

__all__ = ["int8_gemm", "int8_gemm_plain"]

_SIGNATURES = {
    "heat_int8_gemm": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ],
    "heat_int8_gemm_wgmma": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ],
}
_MAX_ROWS = 65535 * 128  # the mma.sync kernel's grid
_I32_MAX = 2 ** 31 - 1
# |a b| <= 128^2 for int8 a, b: K products sum exactly in int32 below this
_MAX_K = (2 ** 31 - 1) // 128 ** 2


def _wgmma_tile_width(k: int) -> int:
    """The wgmma kernel's tile width for a contraction of length k: 128 x 256
    tiles at one block an SM where K gives a tile many slices, 128 x 128 at
    two blocks an SM where it gives few, so that one block's epilogue and
    ring fill overlap the other's main loop."""
    return 256 if k >= 4096 else 128


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
              out_dtype: torch.dtype = torch.float32, _old_kernel: bool = False,
              _bn: Optional[int] = None) -> torch.Tensor:
    """``f32(qa @ qb) * (sa * sb)`` in ``out_dtype`` for non-empty (M, K)
    and (K, N) int8 operands, sa (M, 1) and sb (1, N) f32: a kernel on the
    card, the plain version on the CPU. ``_bn`` (128 or 256) picks the wgmma
    kernel's tile width in place of :func:`_wgmma_tile_width`, for timing
    the rule."""
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
    if k > _MAX_K:
        raise ValueError(f"int8 kernel: K = {k} is past {_MAX_K}, where the int32 accumulator "
                         f"stops being exact")
    if max(m, n) > _I32_MAX:
        raise ValueError(f"int8 kernel: ({m}, {k}) @ ({k}, {n}) is past its limits")
    qa, qb, sa, sb = (x.contiguous() for x in (qa, qb, sa, sb))
    wgmma = not _old_kernel and k % 16 == 0 and qa.data_ptr() % 16 == 0
    if not wgmma and m > _MAX_ROWS:
        raise ValueError(f"int8 mma.sync kernel: M = {m} is past {_MAX_ROWS}")
    out = torch.empty((m, n), dtype=out_dtype, device=qa.device)
    bf16 = int(out_dtype == torch.bfloat16)
    lib = _build.library("int8_gemm", _SIGNATURES)
    with torch.cuda.device(qa.device):
        stream = torch.cuda.current_stream(qa.device).cuda_stream
        if wgmma:
            qbt = torch.empty((n, k), dtype=torch.int8, device=qa.device)  # qb^T, K-major
            bn = _wgmma_tile_width(k) if _bn is None else _bn
            rc = lib.heat_int8_gemm_wgmma(qa.data_ptr(), qb.data_ptr(), qbt.data_ptr(),
                                          sa.data_ptr(), sb.data_ptr(), out.data_ptr(), m, n, k,
                                          bf16, bn, stream)
        else:
            rc = lib.heat_int8_gemm(qa.data_ptr(), qb.data_ptr(), sa.data_ptr(), sb.data_ptr(),
                                    out.data_ptr(), m, n, k, bf16, stream)
    _build.check(lib, rc, "int8_gemm kernel")
    _build.count_launch("int8_gemm")
    return out
