"""Flash attention: the forward kernel, its plain version and the public call.

Counterpart of ``heat_tpu/parallel/pallas_attention.py`` (``_flash_forward``
and ``flash_attention``). The kernel (``csrc/flash_fwd.cu``) replaces
``_flash_kernel`` there: the f32 online softmax over K tiles, the causal
and ``kv_valid`` masks, the causal tile skip and, on request, the
log-sum-exp of each row. It reads the public ``(B, T, H, D)`` layout
through strides, so nothing is transposed around it. Its tiles are its own
compile-time choice (64 query rows by 64 keys in bf16, 16 by 32 in f32);
``block_k`` keeps its meaning in the plain version, the K chunk of the
online softmax, and is not read by the kernel. The JAX kernel's
lane-broadcast ``(B, H, T_q_pad, 128)`` LSE layout and its padding of the
head dim to 128 lanes are TPU artefacts: the LSE here is ``(B, H, T_q)``
f32 and nothing is padded.

On a CPU tensor the forward computes :func:`flash_attention_plain`, the
same function in plain torch, which is also the kernel's oracle. On a CUDA
tensor it launches the kernel or raises. The backward kernels (K7a, K7b,
K8 in ROADMAP §2) come with the training slice; until then the backward
raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple, Union

import torch

from .. import _build
from .attention import NEG_INF

__all__ = ["flash_attention", "flash_attention_plain", "MAX_HEAD_DIM"]

MAX_HEAD_DIM = 128
_BIG = 1e30
_LANES = 128
_I32_MAX = 2 ** 31 - 1

_SIGNATURES = {
    "heat_flash_fwd": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ],
}

Out = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = False, scale: Optional[float] = None,
                          kv_valid: Optional[int] = None, block_k: int = 1024,
                          return_lse: bool = False) -> Out:
    """The kernel's function in plain torch: O ``(B, T_q, H, D)`` in q's
    dtype and, with ``return_lse``, the log-sum-exp ``(B, H, T_q)`` f32
    (``+1e30`` on fully masked rows). The products take the inputs widened
    to f32 (exact for bf16), so on the card they need TF32 off."""
    b, t_q, h, d = q.shape
    t_k = k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    kv_end = max(0, min(t_k if kv_valid is None else int(kv_valid), t_k))
    block_k = max(1, min(block_k, -(-t_k // _LANES) * _LANES))  # the JAX clamp
    dev = q.device
    m = torch.full((b, h, t_q), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, t_q), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, t_q, h, d), dtype=torch.float32, device=dev)
    q_pos = torch.arange(t_q, device=dev)
    qf = q.float()
    for k0 in range(0, t_k, block_k):
        kb, vb = k[:, k0:k0 + block_k], v[:, k0:k0 + block_k]
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kb.float()) * scale
        k_pos = k0 + torch.arange(kb.shape[1], device=dev)
        mask = (k_pos < kv_end)[None, :]
        if causal:
            mask = mask & (k_pos[None, :] <= q_pos[:, None])
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        m_safe = torch.where(m_new <= NEG_INF / 2, 0.0, m_new)
        p = torch.where(mask, torch.exp(s - m_safe[..., None]), 0.0)
        alpha = torch.where(m <= NEG_INF / 2, 0.0, torch.exp(m - m_safe))
        l = alpha * l + p.sum(dim=-1)
        p_mx = p if v.dtype == torch.float32 else p.to(v.dtype)
        pv = torch.einsum("bhqk,bkhd->bqhd", p_mx.float(), vb.float())
        acc = acc * alpha.transpose(1, 2)[..., None] + pv
        m = m_new
    out = (acc / torch.where(l == 0.0, 1.0, l).transpose(1, 2)[..., None]).to(q.dtype)
    if not return_lse:
        return out
    m_safe = torch.where(m <= NEG_INF / 2, 0.0, m)
    lse = torch.where(l == 0.0, _BIG, m_safe + torch.log(torch.clamp(l, min=1e-38)))
    return out, lse


def _flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                   causal: bool, kv_valid: int, block_k: int = 1024,
                   return_lse: bool = False) -> Out:
    """O and, with ``return_lse``, the ``(B, H, T_q)`` f32 log-sum-exp: the
    kernel on the card, the plain version on the CPU."""
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k and v lie on different devices: {q.device}, {k.device}, {v.device}")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, scale=scale, kv_valid=kv_valid,
                                     block_k=block_k, return_lse=return_lse)
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash kernel needs q, k, v all float32 or all bfloat16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    b, t_q, h, d = q.shape
    t_k = k.shape[1]
    if k.shape != (b, t_k, h, d) or v.shape != k.shape:
        raise ValueError(f"q, k, v shapes disagree: {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"flash kernel takes head dims up to {MAX_HEAD_DIM}, got {d}")
    if max(t_q, t_k) > _I32_MAX or b > 65535 or h > 65535:
        raise ValueError(f"flash kernel: shape {tuple(q.shape)} x T_k={t_k} is past its limits")
    q, k, v = (x if x.stride(-1) == 1 else x.contiguous() for x in (q, k, v))
    out = torch.empty((b, t_q, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, t_q), dtype=torch.float32, device=q.device) if return_lse else None
    if out.numel() == 0:
        if lse is not None:
            lse.fill_(_BIG)
        return (out, lse) if return_lse else out
    strides = [s for x in (q, k, v, out) for s in (x.stride(0), x.stride(1), x.stride(2))]
    bf16 = q.dtype == torch.bfloat16
    vec = bf16 and d % 8 == 0 and all(s % 8 == 0 for s in strides) and all(
        x.data_ptr() % 16 == 0 for x in (q, k, v))
    lib = _build.library("flash_fwd", _SIGNATURES)
    with torch.cuda.device(q.device):
        rc = lib.heat_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if lse is not None else None,
            (ctypes.c_longlong * 12)(*strides), b, h, t_q, t_k, d,
            max(0, min(int(kv_valid), t_k)), int(bool(causal)), float(scale), int(bf16),
            int(vec), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, rc, "flash_fwd kernel")
    _build.count_launch("flash_fwd")
    return (out, lse) if return_lse else out


class _FlashAttention(torch.autograd.Function):
    """The forward kernel under autograd. Its backward is the training
    slice's (kernels K7a, K7b, K8): it raises rather than differentiate the
    plain version."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, kv_valid, block_k):
        return _flash_forward(q, k, v, scale, causal, kv_valid, block_k)

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError(
            "flash_attention has no backward yet: its kernels (K7a/K7b two-pass, K8 fused, "
            "ROADMAP §2) come with the training slice"
        )


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    scale: Optional[float] = None,
    kv_valid: Optional[int] = None,
    block_q: int = 512,
    block_k: int = 1024,
    bwd_impl: str = "two_pass",
) -> torch.Tensor:
    """Flash attention, ``(B, T, H, D)`` layout, the contract of the JAX
    package's ``flash_attention``: f32 online softmax, the scale (default
    ``1/sqrt(D)``) applied to the f32 ``Q K^T`` product, K/V positions
    ``>= kv_valid`` masked as padding (``kv_valid`` is clamped to
    ``[0, T_k]``), causal rows see keys at positions ``<=`` their own.
    ``block_q`` is accepted for that signature; the causal skip it sets
    there is exact, so it changes no result. ``bwd_impl`` is validated as
    there; no backward runs yet."""
    if q.ndim != 4:
        raise ValueError(f"expected (B, T, H, D) inputs, got {tuple(q.shape)}")
    if bwd_impl not in ("two_pass", "fused", "auto"):
        raise ValueError(f"bwd_impl must be 'two_pass', 'fused' or 'auto', got {bwd_impl!r}")
    d = q.shape[-1]
    t_k = k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    kv_valid = t_k if kv_valid is None else int(kv_valid)
    return _FlashAttention.apply(q, k, v, scale, causal, kv_valid, block_k)
