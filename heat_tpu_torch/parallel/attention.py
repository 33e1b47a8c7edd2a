"""Blockwise attention on one device, in plain torch.

Counterpart of ``heat_tpu/parallel/attention.py`` (``_block_attn``,
``_finalize``, ``local_attention``): the ``attn_impl="local"`` core of the
transformer, the online-softmax accumulator over K chunks. Layout
``(B, T, H, D)``.

Numerics as in the JAX package: masked scores are the finite ``NEG_INF``
(not ``-inf``), ``m_safe``/``alpha`` guard rows that are still fully
masked, the softmax runs in f32, and for bf16 ``v`` the probabilities round
to bf16 before the PV product. The JAX package runs both products in the
input dtype with f32 accumulation; here the inputs are widened to f32
first, which is the same product (a bf16 x bf16 product is exact in f32)
summed in another order.

The sequence-parallel variants ``ring_attention`` and
``ulysses_attention`` are not ported yet (ROADMAP §1 item 2); the
``ppermute`` and ``all_to_all`` collectives they would run over are.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

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


def ring_attention(*args, **kwargs):
    """Ring attention over a sequence-sharded world: not ported yet."""
    raise NotImplementedError(
        "ring_attention: the sequence-parallel attention itself (K/V blocks circulated "
        "with ppermute) is not ported yet (ROADMAP §1 item 2)"
    )


def ulysses_attention(*args, **kwargs):
    """Ulysses sequence parallelism: not ported yet."""
    raise NotImplementedError(
        "ulysses_attention: the sequence-parallel attention itself (heads exchanged with "
        "all_to_all) is not ported yet (ROADMAP §1 item 2)"
    )
