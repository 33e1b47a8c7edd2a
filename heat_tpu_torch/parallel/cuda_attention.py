"""Flash attention: the forward and backward kernels, their plain versions
and the public call.

Counterpart of ``heat_tpu/parallel/pallas_attention.py``. The kernels:

- ``csrc/flash_fwd.cu`` replaces ``_flash_kernel``: the f32 online softmax
  over K tiles, the causal and ``kv_valid`` masks, the causal tile skip
  and, on request, the log-sum-exp of each row;
- ``csrc/flash_bwd.cu`` replaces the backward's three: ``_bwd_dq_kernel``
  (``flash_bwd_dq``) and ``_bwd_dkv_kernel`` (``flash_bwd_dkv``), the
  two-pass backward, and ``_bwd_fused_kernel`` (``flash_bwd_fused``), the
  single pass. Each rebuilds the probabilities from the saved LSE as
  ``_rebuild_probs`` and ``_bwd_block_terms`` do there.

They read the public ``(B, T, H, D)`` layout through strides, so nothing is
transposed or padded around them. Which kernel takes an input is a shape
rule (:func:`_attention_variant`): bf16 inputs with ``D`` 64 or 128 and
16-byte-aligned rows go to the Hopper kernels of K6, K7a, K7b and K8
(``wgmma``, bulk tensor copies on mbarriers, and for K8 a bulk reduce-add of
dQ into a tile-contiguous workspace), every other input to the ``mma.sync``
and f32 kernels. Their tiles follow shape rules (:func:`_fwd_tiles`,
:func:`_bwd_dq_tiles`, :func:`_bwd_dkv_stages`) or are compile-time
choices; ``block_q`` and ``block_k`` keep their meaning only in the plain
versions, as the K chunk of the online softmax and of the backward's sum.
The JAX kernels' lane-broadcast ``(B, H, T_q_pad, 128)`` LSE layout and
their padding of the head dim to 128 lanes are TPU artefacts: the LSE and
``D`` here are ``(B, H, T_q)`` f32 and nothing is padded.

``D = rowsum(f32(dO) * f32(O))``, the backward's prologue, is computed by
the Hopper K7a for its own rows, which writes it for K7b; everywhere else
(the fused backward, the other kernels, the CPU) it is plain torch, as the
JAX package computes it in XLA outside Pallas (``_bwd_prologue``).

On a CPU tensor the forward and backward compute :func:`flash_attention_plain`
and :func:`flash_attention_bwd_plain`, the same functions in plain torch,
which are also the kernels' oracles. On a CUDA tensor they launch the
kernels or raise.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple, Union

import torch

from .. import _build
from .attention import NEG_INF

__all__ = ["flash_attention", "flash_attention_plain", "flash_attention_bwd_plain",
           "MAX_HEAD_DIM"]

MAX_HEAD_DIM = 128
_BIG = 1e30
_LANES = 128
_I32_MAX = 2 ** 31 - 1
_BWD_IMPLS = ("two_pass", "fused", "auto")
_WGMMA_HEAD_DIMS = (64, 128)
_TMA_MAX_STRIDE = 2 ** 40  # a tensor map's byte strides stay below this
# For inputs off the Hopper gate, "auto" takes the fused backward while T_q is
# at most this. On the H100 the mma.sync K8 was the faster at T = 256, tied or
# lost at T = 512, and two-pass wins from T = 1024 on: that kernel's dQ is a
# sum of scalar f32 atomics over key tiles, whose traffic grows with T
# (PERF.md §6)
_FUSED_MAX_T_Q = 256

_BWD_ARGS = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p,
]
_SIGNATURES = {
    "flash_fwd": {
        "heat_flash_fwd": [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p,
        ],
        "heat_flash_fwd_wgmma": [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ],
    },
    "flash_bwd": {
        **{f"heat_{name}": _BWD_ARGS
           for name in ("flash_bwd_dq", "flash_bwd_dkv", "flash_bwd_fused")},
        "heat_flash_bwd_fused_wgmma": [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_void_p,
        ],
        "heat_flash_bwd_dkv_wgmma": [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
        ],
        "heat_flash_bwd_dq_wgmma": [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ],
    },
}

Out = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]
Grads = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _kv_end(kv_valid: Optional[int], t_k: int) -> int:
    return max(0, min(t_k if kv_valid is None else int(kv_valid), t_k))


def _mask(q_pos, k_pos, kv_end, causal):
    mask = (k_pos < kv_end)[None, :]
    if causal:
        mask = mask & (k_pos[None, :] <= q_pos[:, None])
    return mask


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = False, scale: Optional[float] = None,
                          kv_valid: Optional[int] = None, block_k: int = 1024,
                          return_lse: bool = False) -> Out:
    """The forward kernel's function in plain torch: O ``(B, T_q, H, D)`` in
    q's dtype and, with ``return_lse``, the log-sum-exp ``(B, H, T_q)`` f32
    (``+1e30`` on fully masked rows). The products take the inputs widened
    to f32 (exact for bf16), so on the card they need TF32 off. Float64
    inputs are computed in float64 throughout (an oracle that autograd can
    differentiate)."""
    b, t_q, h, d = q.shape
    t_k = k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    kv_end = _kv_end(kv_valid, t_k)
    block_k = max(1, min(block_k, -(-t_k // _LANES) * _LANES))  # the JAX clamp
    dev = q.device
    wide = torch.float64 if q.dtype == torch.float64 else torch.float32
    m = torch.full((b, h, t_q), NEG_INF, dtype=wide, device=dev)
    l = torch.zeros((b, h, t_q), dtype=wide, device=dev)
    acc = torch.zeros((b, t_q, h, d), dtype=wide, device=dev)
    q_pos = torch.arange(t_q, device=dev)
    qf = q.to(wide)
    for k0 in range(0, t_k, block_k):
        kb, vb = k[:, k0:k0 + block_k], v[:, k0:k0 + block_k]
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kb.to(wide)) * scale
        mask = _mask(q_pos, k0 + torch.arange(kb.shape[1], device=dev), kv_end, causal)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        m_safe = torch.where(m_new <= NEG_INF / 2, 0.0, m_new)
        p = torch.where(mask, torch.exp(s - m_safe[..., None]), 0.0)
        alpha = torch.where(m <= NEG_INF / 2, 0.0, torch.exp(m - m_safe))
        l = alpha * l + p.sum(dim=-1)
        p_mx = p if v.dtype == wide else p.to(v.dtype)
        pv = torch.einsum("bhqk,bkhd->bqhd", p_mx.to(wide), vb.to(wide))
        acc = acc * alpha.transpose(1, 2)[..., None] + pv
        m = m_new
    out = (acc / torch.where(l == 0.0, 1.0, l).transpose(1, 2)[..., None]).to(q.dtype)
    if not return_lse:
        return out
    m_safe = torch.where(m <= NEG_INF / 2, 0.0, m)
    lse = torch.where(l == 0.0, _BIG, m_safe + torch.log(torch.clamp(l, min=1e-38)))
    return out, lse


def _row_terms(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """``D = rowsum(f32(dO) * f32(O))``, ``(B, H, T_q)`` f32 contiguous."""
    return (do.float() * o.float()).sum(dim=-1).transpose(1, 2).contiguous()


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
                              causal: bool, scale: float, kv_valid: Optional[int] = None,
                              block_q: int = 512, block_k: int = 1024,
                              fused: bool = False) -> Grads:
    """The backward kernels' function in plain torch: ``(dQ, dK, dV)`` in the
    dtypes of q, k and v, from the forward's O and ``(B, H, T_q)`` LSE and
    the cotangent dO, blockwise over K chunks of ``block_k`` (clamped as the
    JAX package clamps it). Per chunk, as ``_bwd_block_terms``:
    ``p = where(mask, exp(s - lse), 0)`` with ``s = (q k^T) scale`` in f32,
    ``dP = dO V^T``, ``dS = p (dP - D) scale``; for bf16 inputs p rounds to
    dO's dtype before ``P^T dO`` and dS to q's before ``dS K`` and
    ``dS^T Q``. Every sum is f32 and each output is cast once. The products
    take the inputs widened to f32 (exact for bf16), so on the card they
    need TF32 off.

    ``fused`` selects the single-pass schedule and ``block_q`` the query
    blocks of the JAX kernels; both change only the order in which the same
    f32 terms are summed there, so here they change nothing."""
    del block_q, fused
    b, t_q, h, d = q.shape
    t_k = k.shape[1]
    kv_end = _kv_end(kv_valid, t_k)
    block_k = max(1, min(block_k, -(-t_k // _LANES) * _LANES))
    dev = q.device
    dd = _row_terms(o, do)[..., None]
    lse = lse[..., None]
    qf, dof = q.float(), do.float()
    q_pos = torch.arange(t_q, device=dev)
    dq = torch.zeros((b, t_q, h, d), dtype=torch.float32, device=dev)
    dk = torch.zeros((b, t_k, h, d), dtype=torch.float32, device=dev)
    dv = torch.zeros((b, t_k, h, d), dtype=torch.float32, device=dev)
    for k0 in range(0, t_k, block_k):
        kb, vb = k[:, k0:k0 + block_k].float(), v[:, k0:k0 + block_k].float()
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kb) * scale
        mask = _mask(q_pos, k0 + torch.arange(kb.shape[1], device=dev), kv_end, causal)
        s = torch.where(mask, s, NEG_INF)
        p = torch.where(mask, torch.exp(s - lse), 0.0)
        p_mx = p if do.dtype == torch.float32 else p.to(do.dtype).float()
        dp = torch.einsum("bqhd,bkhd->bhqk", dof, vb)
        ds = p * (dp - dd) * scale
        ds_mx = ds if q.dtype == torch.float32 else ds.to(q.dtype).float()
        dv[:, k0:k0 + block_k] = torch.einsum("bhqk,bqhd->bkhd", p_mx, dof)
        dk[:, k0:k0 + block_k] = torch.einsum("bhqk,bqhd->bkhd", ds_mx, qf)
        dq += torch.einsum("bhqk,bkhd->bqhd", ds_mx, kb)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_inputs(what: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  *more: torch.Tensor) -> None:
    """Raise unless the kernels take these tensors: one CUDA device, all
    float32 or all bfloat16, (B, T, H, D) shapes that agree, D <= 128 and
    sizes inside 32-bit indices and grid dimensions."""
    tensors = (q, k, v, *more)
    if len({x.device for x in tensors}) != 1:
        raise ValueError(f"{what}: inputs lie on different devices: "
                         f"{[str(x.device) for x in tensors]}")
    if q.dtype not in (torch.float32, torch.bfloat16) or any(x.dtype != q.dtype for x in tensors):
        raise ValueError(f"{what} needs its inputs all float32 or all bfloat16, got "
                         f"{[x.dtype for x in tensors]}")
    b, t_q, h, d = q.shape
    t_k = k.shape[1]
    if k.shape != (b, t_k, h, d) or v.shape != k.shape or any(x.shape != q.shape for x in more):
        raise ValueError(f"{what}: shapes disagree: {[tuple(x.shape) for x in tensors]}")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"{what} takes head dims up to {MAX_HEAD_DIM}, got {d}")
    if max(t_q, t_k) > _I32_MAX or b > 65535 or h > 65535:
        raise ValueError(f"{what}: shape {tuple(q.shape)} x T_k={t_k} is past its limits")


def _unit_stride(*tensors: torch.Tensor):
    return [x if x.stride(-1) == 1 else x.contiguous() for x in tensors]


def _strides(*tensors: torch.Tensor):
    """The element strides (batch, time, head) of each (B, T, H, D) tensor.
    A dimension of size 1 is never stepped over, and torch may give it any
    stride, so it gets the stride a contiguous tensor would have there."""
    out = []
    for x in tensors:
        s_b, s_t, s_h, _ = x.stride()
        b, t, h, d = x.shape
        if b == 1 or t == 1 or h == 1:
            s_b, s_t, s_h = (s_b if b != 1 else t * h * d, s_t if t != 1 else h * d,
                             s_h if h != 1 else d)
        out += (s_b, s_t, s_h)
    return out


def _attention_variant(dtype: torch.dtype, d: int, strides, aligned: bool) -> str:
    """Which kernel family takes these operands, by a shape rule alone:

    - ``"f32"``: float32 inputs, exact f32 FMAs;
    - ``"bf16_wgmma"``: bfloat16 with ``D`` 64 or 128, every stride (in
      elements, over batch, time and head) a positive multiple of 8 and
      every base pointer 16-byte aligned (``aligned``), so that each row is
      a legal bulk-tensor-copy source: the Hopper kernels (``wgmma``, tensor
      maps, mbarriers);
    - ``"bf16_mma"``: bfloat16 with ``D % 8 == 0`` and aligned rows
      otherwise (``D <= 32``, or 64 < ``D`` < 128, ...): ``mma.sync`` with
      16-byte ``cp.async``;
    - ``"bf16_scalar"``: any other bfloat16 input: ``mma.sync`` with
      value-by-value loads.
    """
    if dtype != torch.bfloat16:
        return "f32"
    if not (aligned and d % 8 == 0 and all(s % 8 == 0 for s in strides)):
        return "bf16_scalar"
    if d in _WGMMA_HEAD_DIMS and all(0 < s * 2 < _TMA_MAX_STRIDE for s in strides):
        return "bf16_wgmma"
    return "bf16_mma"


def _tensor_map_layout(x: torch.Tensor, strides=None):
    """What the tensor map over a (B, T, H, D) view is encoded from, innermost
    dimension first: D, T, H, B, then the byte strides of T, H and B.
    ``strides`` are x's :func:`_strides` where the caller has them already."""
    b, t, h, d = x.shape
    s_b, s_t, s_h = _strides(x) if strides is None else strides
    es = x.element_size()
    return (d, t, h, b, s_t * es, s_h * es, s_b * es)


def _bwd_dq_tiles(t_q: int, d: int) -> Tuple[int, int]:
    """The wgmma K7a's (query rows a block, keys a tile), from the times on
    the H100 (PERF.md §6, ``chip_smoke.py``'s "flash_bwd two-pass choices"
    line). ``D = 64``: 64 rows (one consumer warpgroup, two blocks an SM) by
    64 keys. ``D = 128``: 128 rows (two consumer warpgroups) by 64 keys, the
    one variant there that does not spill."""
    return (64, 64) if d == 64 else (128, 64)


def _bwd_dkv_stages(d: int) -> int:
    """The slots of the wgmma K7b's Q and dO ring, from the same times: two
    at either ``D``. K7b keeps K8's blocks (one consumer warpgroup and two
    blocks an SM at ``D = 64``, set by its registers; two warpgroups and one
    block at ``D = 128``), and more slots bought no time there."""
    del d
    return 2


def _fwd_tiles(t_q: int, d: int) -> Tuple[int, int]:
    """The wgmma forward's (query rows a block, keys a tile), from the times
    on the H100 (PERF.md §6). ``D = 64``: 64 rows (one consumer
    warpgroup, three blocks an SM) by 64 keys. ``D = 128``: 128-key tiles,
    and 128 rows (two consumer warpgroups) where ``T_q`` has more than 64."""
    if d == 64:
        return 64, 64
    return (128 if t_q > 64 else 64), 128


def _flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                   causal: bool, kv_valid: int, block_k: int = 1024,
                   return_lse: bool = False, _old_kernel: bool = False,
                   _tiles: Optional[Tuple[int, int]] = None) -> Out:
    """O and, with ``return_lse``, the ``(B, H, T_q)`` f32 log-sum-exp: the
    kernel on the card, the plain version on the CPU. The kernel is picked by
    :func:`_attention_variant`. ``_old_kernel`` sends operands that the
    wgmma kernel takes to the ``mma.sync`` one instead, and ``_tiles`` sets
    the wgmma kernel's (rows a block, keys a tile): both are for timing one
    kernel against the other on the card, not options."""
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k and v lie on different devices: {q.device}, {k.device}, {v.device}")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, scale=scale, kv_valid=kv_valid,
                                     block_k=block_k, return_lse=return_lse)
    _check_inputs("flash kernel", q, k, v)
    b, t_q, h, d = q.shape
    t_k = k.shape[1]
    q, k, v = _unit_stride(q, k, v)
    out = torch.empty((b, t_q, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, t_q), dtype=torch.float32, device=q.device) if return_lse else None
    if out.numel() == 0:
        if lse is not None:
            lse.fill_(_BIG)
        return (out, lse) if return_lse else out
    strides = _strides(q, k, v, out)
    variant = _attention_variant(q.dtype, d, strides,
                                 all(x.data_ptr() % 16 == 0 for x in (q, k, v)))
    if variant == "bf16_wgmma" and (_old_kernel or not scale > 0):
        variant = "bf16_mma"  # the wgmma forward folds a positive scale into its exponent
    lib = _build.library("flash_fwd", _SIGNATURES["flash_fwd"])
    pointers = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr() if lse is not None else None)
    sizes = (b, h, t_q, t_k, d, _kv_end(kv_valid, t_k), int(bool(causal)), float(scale))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        if variant == "bf16_wgmma":
            layouts = (*_tensor_map_layout(q, strides[0:3]), *_tensor_map_layout(k, strides[3:6]),
                       *_tensor_map_layout(v, strides[6:9]))
            bm, bn = _tiles if _tiles is not None else _fwd_tiles(t_q, d)
            rc = lib.heat_flash_fwd_wgmma(
                *pointers, (ctypes.c_longlong * 21)(*layouts),
                (ctypes.c_longlong * 3)(*strides[9:]), *sizes, bm, bn, stream)
        else:
            rc = lib.heat_flash_fwd(
                *pointers, (ctypes.c_longlong * 12)(*strides), *sizes,
                int(variant != "f32"), int(variant == "bf16_mma"), stream)
    _build.check(lib, rc, f"flash_fwd kernel ({variant})")
    _build.count_launch("flash_fwd")
    return (out, lse) if return_lse else out


def _launch_bwd(name: str, q, k, v, do, lse, dd, dq, dk, dv, scale, causal, kv_valid) -> None:
    """One backward kernel (``name`` is its launch counter and C entry); the
    outputs it does not write may be None."""
    b, t_q, h, d = q.shape
    t_k = k.shape[1]
    outs = [x if x is not None else q for x in (dq, dk, dv)]  # strides only
    strides = _strides(q, k, v, do, *outs)
    bf16 = q.dtype == torch.bfloat16
    vec = bf16 and d % 8 == 0 and all(s % 8 == 0 for s in strides[:12]) and all(
        x.data_ptr() % 16 == 0 for x in (q, k, v, do))
    lib = _build.library("flash_bwd", _SIGNATURES["flash_bwd"])
    ptr = (lambda x: x.data_ptr() if x is not None else None)
    with torch.cuda.device(q.device):
        rc = getattr(lib, f"heat_{name}")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            dd.data_ptr(), ptr(dq), ptr(dk), ptr(dv), (ctypes.c_longlong * 21)(*strides),
            b, h, t_q, t_k, d, _kv_end(kv_valid, t_k), int(bool(causal)), float(scale),
            int(bf16), int(vec), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, rc, f"{name} kernel")
    _build.count_launch(name)


def _bwd_checked(q, k, v, o, lse, do):
    """Checks the backward's operands for the kernels and returns q, k, v, do
    with unit stride over D and lse contiguous."""
    _check_inputs("flash backward kernel", q, k, v, o, do)
    b, t_q, h, _ = q.shape
    if lse.shape != (b, h, t_q) or lse.dtype != torch.float32 or lse.device != q.device:
        raise ValueError(f"flash backward kernel: lse must be ({b}, {h}, {t_q}) float32 on "
                         f"{q.device}, got {tuple(lse.shape)} {lse.dtype} on {lse.device}")
    q, k, v, do = _unit_stride(q, k, v, do)
    return q, k, v, do, lse.contiguous()


def _bwd_operands(q, k, v, o, lse, do):
    """:func:`_bwd_checked`'s operands and D (``(B, H, T_q)`` f32)."""
    q, k, v, do, lse = _bwd_checked(q, k, v, o, lse, do)
    return q, k, v, do, lse, _row_terms(o, do)


def _rows_aligned(x: torch.Tensor) -> bool:
    """Whether every row of a (B, T, H, D) bf16 tensor starts on 16 bytes
    and its D values are contiguous: what 16-byte loads of a row need."""
    return (x.stride(-1) == 1 and x.data_ptr() % 16 == 0
            and all(s % 8 == 0 for s in _strides(x)))


def _launch_dq_wgmma(q, k, v, do, o, lse, dd, dq, scale, causal, kv_valid, tiles) -> None:
    """The wgmma K7a on checked operands: writes dQ into ``dq`` and D of
    every row into ``dd`` (``(B, H, T_q)`` f32, contiguous), with ``tiles``
    (query rows a block, keys a tile). ``o`` must have aligned rows
    (:func:`_rows_aligned`)."""
    b, t_q, h, d = q.shape
    t_k = k.shape[1]
    layouts = [n for x in (q, k, v, do) for n in _tensor_map_layout(x)]
    lib = _build.library("flash_bwd", _SIGNATURES["flash_bwd"])
    with torch.cuda.device(q.device):
        rc = lib.heat_flash_bwd_dq_wgmma(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), o.data_ptr(),
            lse.data_ptr(), dd.data_ptr(), dq.data_ptr(), (ctypes.c_longlong * 28)(*layouts),
            (ctypes.c_longlong * 6)(*_strides(o, dq)), b, h, t_q, t_k, d,
            _kv_end(kv_valid, t_k), int(bool(causal)), float(scale), *tiles,
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, rc, "flash_bwd_dq kernel (bf16_wgmma)")
    _build.count_launch("flash_bwd_dq")


def _launch_dkv_wgmma(q, k, v, do, lse, dd, dk, dv, scale, causal, kv_valid, stages) -> None:
    """The wgmma K7b on checked operands: writes dK and dV from D in ``dd``
    (as K7a wrote it), with a ring of ``stages`` Q and dO slots."""
    b, t_q, h, d = q.shape
    t_k = k.shape[1]
    layouts = [n for x in (q, k, v, do) for n in _tensor_map_layout(x)]
    lib = _build.library("flash_bwd", _SIGNATURES["flash_bwd"])
    with torch.cuda.device(q.device):
        rc = lib.heat_flash_bwd_dkv_wgmma(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            dd.data_ptr(), dk.data_ptr(), dv.data_ptr(), (ctypes.c_longlong * 28)(*layouts),
            (ctypes.c_longlong * 6)(*_strides(dk, dv)), b, h, t_q, t_k, d,
            _kv_end(kv_valid, t_k), int(bool(causal)), float(scale), int(stages),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, rc, "flash_bwd_dkv kernel (bf16_wgmma)")
    _build.count_launch("flash_bwd_dkv")


def _flash_bwd(q, k, v, o, lse, do, scale, causal, kv_valid, block_q=512,
               block_k=1024, _old_kernel: bool = False) -> Grads:
    """The two-pass backward: dQ by K7a (``flash_bwd_dq``), then dK and dV
    by K7b (``flash_bwd_dkv``) on the card; the plain version on the CPU.
    ``_old_kernel`` is for timing the Hopper kernels against the ``mma.sync``
    ones on the card, not an option (:func:`_two_pass_kernels`)."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal, scale=scale,
                                         kv_valid=kv_valid, block_q=block_q, block_k=block_k)
    return _two_pass_kernels(q, k, v, o, lse, do, scale, causal, kv_valid, _old_kernel)


def _two_pass_kernels(q, k, v, o, lse, do, scale, causal, kv_valid, old_kernel=False) -> Grads:
    """K7a then K7b on the operands as :func:`_flash_bwd` gets them. For
    operands that :func:`_attention_variant` calls ``"bf16_wgmma"`` the
    Hopper kernels run, with :func:`_bwd_dq_tiles` and
    :func:`_bwd_dkv_stages`: K7a computes D itself and writes it to a
    ``(B, H, T_q)`` f32 buffer that K7b reads, so no plain-torch prologue
    runs. Any other input, or ``old_kernel``, takes the ``mma.sync`` or f32
    kernels after the plain prologue, and so do empty ones (a tensor map
    cannot span a dimension of size 0)."""
    b, t_q, h, d = q.shape
    if _bwd_variant(q, k, v, do) != "bf16_wgmma" or old_kernel or q.numel() * k.numel() == 0:
        q, k, v, do, lse, dd = _bwd_operands(q, k, v, o, lse, do)
        if d == 0:
            return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        _launch_bwd("flash_bwd_dq", q, k, v, do, lse, dd, dq, None, None, scale, causal,
                    kv_valid)
        _launch_bwd("flash_bwd_dkv", q, k, v, do, lse, dd, None, dk, dv, scale, causal,
                    kv_valid)
        return dq, dk, dv
    q, k, v, do, lse = _bwd_checked(q, k, v, o, lse, do)
    o = o if _rows_aligned(o) else o.clone(memory_format=torch.contiguous_format)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dd = torch.empty((b, h, t_q), dtype=torch.float32, device=q.device)
    _launch_dq_wgmma(q, k, v, do, o, lse, dd, dq, scale, causal, kv_valid,
                     _bwd_dq_tiles(t_q, d))
    _launch_dkv_wgmma(q, k, v, do, lse, dd, dk, dv, scale, causal, kv_valid,
                      _bwd_dkv_stages(d))
    return dq, dk, dv


_DQ_TILE = 64  # query rows of one dQ partial of the wgmma K8


def _dq_workspace(b: int, h: int, t_q: int, d: int, device) -> torch.Tensor:
    """The zeroed f32 dQ workspace of the wgmma K8, ``(B, H, T_q rounded up
    to 64, D)``: private to the wrapper, laid out so that every 64-row tile
    of a head is contiguous and one bulk reduce-add can add a whole partial.
    The rows past ``T_q`` only ever receive zeros."""
    t_pad = -(-t_q // _DQ_TILE) * _DQ_TILE
    return torch.zeros((b, h, t_pad, d), dtype=torch.float32, device=device)


def _dq_from_workspace(ws: torch.Tensor, t_q: int, dtype: torch.dtype) -> torch.Tensor:
    """dQ as contiguous ``(B, T_q, H, D)`` in ``dtype`` from the workspace:
    one pass that drops the padding, transposes and casts."""
    b, h, _, d = ws.shape
    dq = torch.empty((b, t_q, h, d), dtype=dtype, device=ws.device)
    dq.copy_(ws[:, :, :t_q].transpose(1, 2))
    return dq


def _launch_fused_wgmma(q, k, v, do, lse, dd, ws, dk, dv, scale, causal, kv_valid) -> None:
    """The wgmma K8 on checked operands: adds dQ into the workspace ``ws`` of
    :func:`_dq_workspace` and writes dK and dV."""
    b, t_q, h, d = q.shape
    t_k = k.shape[1]
    layouts = [n for x in (q, k, v, do) for n in _tensor_map_layout(x)]
    lib = _build.library("flash_bwd", _SIGNATURES["flash_bwd"])
    with torch.cuda.device(q.device):
        rc = lib.heat_flash_bwd_fused_wgmma(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            dd.data_ptr(), ws.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            (ctypes.c_longlong * 28)(*layouts), (ctypes.c_longlong * 6)(*_strides(dk, dv)),
            b, h, t_q, t_k, d, _kv_end(kv_valid, t_k), int(bool(causal)), float(scale),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, rc, "flash_bwd_fused kernel (bf16_wgmma)")
    _build.count_launch("flash_bwd_fused")


def _flash_bwd_fused(q, k, v, o, lse, do, scale, causal, kv_valid, block_q=512,
                     block_k=1024, _old_kernel: bool = False) -> Grads:
    """The single-pass backward, K8 (``flash_bwd_fused``), on the card; the
    plain version on the CPU. Its key-tile blocks add f32 dQ partials into a
    zeroed workspace that is cast once to q's dtype. For operands that
    :func:`_attention_variant` calls ``"bf16_wgmma"`` the Hopper kernel adds
    each 64-row partial by one bulk reduce-add into the tile-contiguous
    workspace of :func:`_dq_workspace`; any other input, or ``_old_kernel``
    (for timing one against the other on the card), takes the ``mma.sync``
    kernel, which adds into a ``(B, T_q, H, D)`` workspace value by value."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal, scale=scale,
                                         kv_valid=kv_valid, block_q=block_q, block_k=block_k,
                                         fused=True)
    q, k, v, do, lse, dd = _bwd_operands(q, k, v, o, lse, do)
    b, t_q, h, d = q.shape
    t_k = k.shape[1]
    if d == 0:
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if _bwd_variant(q, k, v, do) != "bf16_wgmma" or _old_kernel:
        dq32 = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        _launch_bwd("flash_bwd_fused", q, k, v, do, lse, dd, dq32, dk, dv, scale, causal,
                    kv_valid)
        return dq32.to(q.dtype), dk, dv
    ws = _dq_workspace(b, h, t_q, d, q.device)
    _launch_fused_wgmma(q, k, v, do, lse, dd, ws, dk, dv, scale, causal, kv_valid)
    return _dq_from_workspace(ws, t_q, q.dtype), dk, dv


def _resolve_bwd_impl(bwd_impl: str, t_q: int, variant: str = "f32") -> str:
    """``"auto"`` by the port's shape rule, from the times on the H100
    (PERF.md §6): two-pass for the operands that the Hopper K7a and K7b take
    (``variant`` ``"bf16_wgmma"`` of :func:`_attention_variant`), whatever
    ``T_q``: their wrapper was as fast as the fused one or faster at every
    length measured, and it is bit-reproducible; for any other input fused
    while ``T_q`` is at most ``_FUSED_MAX_T_Q``, else two-pass. The TPU's
    rule (the resident f32 dQ block fits VMEM) does not carry over: here dQ
    lives in device memory."""
    if bwd_impl == "auto":
        if variant == "bf16_wgmma":
            return "two_pass"
        return "fused" if t_q <= _FUSED_MAX_T_Q else "two_pass"
    return bwd_impl


def _bwd_variant(q, k, v, do) -> str:
    """:func:`_attention_variant` of the backward's operands as the kernels
    will get them (unit stride over D)."""
    q, k, v, do = _unit_stride(q, k, v, do)
    return _attention_variant(q.dtype, q.shape[-1], _strides(q, k, v, do),
                              all(x.data_ptr() % 16 == 0 for x in (q, k, v, do)))


def _flash_bwd_dispatch(bwd_impl, q, k, v, o, lse, do, scale, causal, kv_valid, block_q=512,
                        block_k=1024) -> Grads:
    """``"two_pass"``, ``"fused"`` or ``"auto"``, as ``_flash_bwd_dispatch``
    of the JAX package."""
    variant = _bwd_variant(q, k, v, do) if bwd_impl == "auto" else "f32"
    impl = _resolve_bwd_impl(bwd_impl, q.shape[1], variant)
    if impl not in ("two_pass", "fused"):
        raise ValueError(f"bwd_impl must be 'two_pass', 'fused' or 'auto', got {bwd_impl!r}")
    run = _flash_bwd_fused if impl == "fused" else _flash_bwd
    return run(q, k, v, o, lse, do, scale, causal, kv_valid, block_q, block_k)


class _FlashAttention(torch.autograd.Function):
    """The flash kernels under autograd, the counterpart of the JAX
    package's ``jax.custom_vjp`` ``_flash``: the forward keeps the LSE and
    O, the backward rebuilds the probabilities from them."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, kv_valid, block_q, block_k, bwd_impl):
        out, lse = _flash_forward(q, k, v, scale, causal, kv_valid, block_k, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (scale, causal, kv_valid, block_q, block_k, bwd_impl)
        return out

    @staticmethod
    def backward(ctx, grad):
        q, k, v, out, lse = ctx.saved_tensors
        scale, causal, kv_valid, block_q, block_k, bwd_impl = ctx.args
        dq, dk, dv = _flash_bwd_dispatch(bwd_impl, q, k, v, out, lse, grad, scale, causal,
                                         kv_valid, block_q, block_k)
        return dq, dk, dv, None, None, None, None, None, None


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
    there is exact, so it changes no result.

    Differentiable in q, k and v. ``bwd_impl`` picks the backward:
    ``"two_pass"`` (the default, kernels K7a then K7b), ``"fused"`` (K8) or
    ``"auto"`` (two-pass for bf16 inputs with ``D`` 64 or 128 and
    16-byte-aligned rows, which the Hopper kernels take; else fused while
    ``T_q <= 256``). A call
    that needs no gradient (grad mode off, or no input that requires one) runs
    the forward alone,
    without the LSE, as the JAX package's primal ``_flash`` does;
    ``needs_input_grad`` cannot tell, since it stays True under
    ``torch.no_grad()``."""
    if q.ndim != 4:
        raise ValueError(f"expected (B, T, H, D) inputs, got {tuple(q.shape)}")
    if bwd_impl not in _BWD_IMPLS:
        raise ValueError(f"bwd_impl must be 'two_pass', 'fused' or 'auto', got {bwd_impl!r}")
    d = q.shape[-1]
    t_k = k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    kv_valid = t_k if kv_valid is None else int(kv_valid)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashAttention.apply(q, k, v, scale, causal, kv_valid, block_q, block_k,
                                     bwd_impl)
    return _flash_forward(q, k, v, scale, causal, kv_valid, block_k)
