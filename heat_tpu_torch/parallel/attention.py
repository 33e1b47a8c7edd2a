"""Blockwise attention, on one device and over a sequence-split world.

Counterpart of ``heat_tpu/parallel/attention.py``: ``_block_attn``,
``_finalize`` and ``local_attention`` (the ``attn_impl="local"`` core of the
transformer, the online-softmax accumulator over K chunks), and the
sequence-parallel ``ring_attention`` and ``ulysses_attention``. Layout
``(B, T, H, D)``.

Numerics as in the JAX package: masked scores are the finite ``NEG_INF``
(not ``-inf``), ``m_safe``/``alpha`` guard rows that are still fully
masked, the softmax runs in f32, and for bf16 ``v`` the probabilities round
to bf16 before the PV product. The JAX package runs both products in the
input dtype with f32 accumulation; here the inputs are widened to f32
first, which is the same product (a bf16 x bf16 product is exact in f32)
summed in another order.

The sequence-parallel variants take this rank's chunk of the sequence,
``(B, T_pad / p, H, D)`` with the same chunk length on every rank (the JAX
package's ``T_pad`` divisible by the mesh), and return this rank's chunk of
the output; positions ``>= seq_len`` are padding. ``ring_attention`` keeps
the Q chunk and circulates K and V (stacked, one ``ppermute`` a hop) around
the ring on ``ring_pipeline``, carrying the online softmax over the ``p``
chunks; its ``p``-th hop, which the JAX package's loop makes and nobody
reads, is not made.
Each hop's block step runs under ``torch.utils.checkpoint`` when a gradient
is recorded, so the backward keeps one hop's scores at a time, not ``p``.
``ulysses_attention`` exchanges Q, K and V (stacked, one ``all_to_all``)
from sequence chunks to head groups, attends over the whole sequence
(``local_attention``, or the flash kernel with ``use_pallas=True``) and
exchanges back. The hops are differentiable
(``core/communication.py``), so ``loss.backward()`` returns the gradient
that travels back over them.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..core.communication import TorchCommunication
from .ring import ring_pipeline

__all__ = ["NEG_INF", "local_attention", "ring_attention", "ulysses_attention"]

NEG_INF = -1e30


def _block_attn(q, k, v, m, l, o, q_start, k_start, scale, causal, kv_len_valid):
    """One accumulation step: q (B, Tq, H, D); k, v (B, Tk, H, D) starting at
    global position ``k_start``; m, l (B, H, Tq) f32; o (B, Tq, H, D) f32."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    k_pos = k_start + torch.arange(k.shape[1], device=q.device)
    mask = k_pos[None, :] < kv_len_valid
    if causal:
        q_pos = q_start + torch.arange(q.shape[1], device=q.device)
        mask = mask & (k_pos[None, :] <= q_pos[:, None])
    s = torch.where(mask, s, NEG_INF)

    m_new = torch.maximum(m, s.amax(dim=-1))
    m_safe = torch.where(m_new <= NEG_INF / 2, 0.0, m_new)
    p = torch.where(mask, torch.exp(s - m_safe[..., None]), 0.0)
    dead = m <= NEG_INF / 2
    alpha = torch.where(dead, 0.0, torch.exp(torch.where(dead, NEG_INF, m) - m_safe))
    l_new = alpha * l + p.sum(dim=-1)
    p_mx = p if v.dtype == torch.float32 else p.to(v.dtype)
    pv = torch.einsum("bhqk,bkhd->bqhd", p_mx.float(), v.float())
    o_new = o * alpha.transpose(1, 2)[..., None] + pv
    return m_new, l_new, o_new


def _finalize(m, l, o):
    denom = torch.where(l == 0.0, 1.0, l)
    return o / denom.transpose(1, 2)[..., None]


def local_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    scale: Optional[float] = None,
    block_size: int = 512,
    kv_valid: Optional[int] = None,
) -> torch.Tensor:
    """Blockwise (flash) attention on one device, ``(B, T, H, D)`` layout.

    K/V are processed in ``block_size`` chunks with the online softmax;
    K/V positions ``>= kv_valid`` are masked as padding. Like the JAX
    package, the K/V tail is zero-padded to a whole chunk, so positions
    past ``T_k`` but below ``kv_valid`` count as zero keys.
    """
    b, tq, h, d = q.shape
    tk = k.shape[1]
    kv_valid = tk if kv_valid is None else kv_valid
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    nblk = max(1, -(-tk // block_size))
    pad = nblk * block_size - tk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    m = torch.full((b, h, tq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, tq), dtype=torch.float32, device=q.device)
    o = torch.zeros((b, tq, h, d), dtype=torch.float32, device=q.device)
    for i in range(nblk):
        k_start = i * block_size
        m, l, o = _block_attn(
            q, k[:, k_start:k_start + block_size], v[:, k_start:k_start + block_size],
            m, l, o, 0, k_start, scale, causal, kv_valid,
        )
    return _finalize(m, l, o).to(q.dtype)


def _chunk_len(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, comm) -> int:
    if q.ndim != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"expected three (B, T/p, H, D) chunks of one shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if not isinstance(comm, TorchCommunication):
        raise TypeError(f"comm must be a TorchCommunication, got {comm!r}")
    return q.shape[1]


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    comm: TorchCommunication,
    causal: bool = False,
    scale: Optional[float] = None,
    seq_len: Optional[int] = None,
) -> torch.Tensor:
    """Ring attention over a sequence-split world (Liu et al. 2023; the JAX
    package's ``ring_attention``).

    ``q``, ``k``, ``v``: this rank's chunk ``(B, T_pad / p, H, D)`` of the
    sequence, the same length on every rank; positions ``>= seq_len``
    (default ``T_pad``) are padding and masked out of the softmax. Each
    rank keeps its Q chunk and circulates its K/V chunk one hop a step; the
    flash accumulator makes the ``p`` partial softmaxes exact. Returns this
    rank's chunk of the output. The block step is the plain
    ``_block_attn``, as in the JAX package (no kernel)."""
    tc = _chunk_len(q, k, v, comm)
    p, rank = comm.size, comm.rank
    b, _, h, d = q.shape
    seq_len = tc * p if seq_len is None else int(seq_len)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    m = torch.full((b, h, tc), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, tc), dtype=torch.float32, device=q.device)
    o = torch.zeros((b, tc, h, d), dtype=torch.float32, device=q.device)
    recording = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))

    def block(q_, kv_, m_, l_, o_, k_start):
        return _block_attn(q_, kv_[0], kv_[1], m_, l_, o_, rank * tc, k_start, scale, causal,
                           seq_len)

    def step(t, origin, q_, kv_, carry):
        if recording:
            return checkpoint(block, q_, kv_, *carry, origin * tc, use_reentrant=False)
        return block(q_, kv_, *carry, origin * tc)

    m, l, o = ring_pipeline(step, q, torch.stack([k, v]), (m, l, o), comm=comm)
    return _finalize(m, l, o).to(q.dtype)


def ulysses_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    comm: TorchCommunication,
    causal: bool = False,
    scale: Optional[float] = None,
    seq_len: Optional[int] = None,
    block_size: int = 512,
    use_pallas: bool = False,
) -> torch.Tensor:
    """Ulysses sequence parallelism (Jacobs et al. 2023; the JAX package's
    ``ulysses_attention``).

    ``q``, ``k``, ``v``: this rank's chunk ``(B, T_pad / p, H, D)``, the same
    length on every rank; ``H`` must divide over the ``p`` ranks. One
    ``all_to_all`` turns the sequence chunks into head groups
    ``(B, T_pad, H / p, D)``, attention runs over the whole sequence with
    K/V positions ``>= seq_len`` masked, and one ``all_to_all`` turns the
    result back into this rank's sequence chunk. ``use_pallas=True`` runs
    the flash kernel (:func:`heat_tpu_torch.parallel.flash_attention`, its
    kernels under autograd) at its own tiles, else the blockwise
    ``local_attention`` with ``block_size``."""
    tc = _chunk_len(q, k, v, comm)
    p = comm.size
    b, _, h, d = q.shape
    if h % p != 0:
        raise ValueError(f"heads ({h}) must divide over mesh size ({p})")
    t_pad = tc * p
    seq_len = t_pad if seq_len is None else int(seq_len)
    # (3, B, T/p, H, D) -> (3, B, T, H/p, D): gather the sequence, scatter the heads
    qkv = comm.all_to_all(torch.stack([q, k, v]), 3, 2, h, t_pad)
    qh, kh, vh = qkv.unbind(0)
    if use_pallas:
        from .cuda_attention import flash_attention

        oh = flash_attention(qh, kh, vh, causal=causal, scale=scale, kv_valid=seq_len)
    else:
        oh = local_attention(qh, kh, vh, causal=causal, scale=scale, block_size=block_size,
                             kv_valid=seq_len)
    return comm.all_to_all(oh, 1, 2, t_pad, h)
