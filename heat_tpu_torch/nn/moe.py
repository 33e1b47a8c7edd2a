"""Mixture-of-experts feed-forward layer, expert-parallel over the ranks
(counterpart of ``heat_tpu/nn/moe.py``).

Switch-style top-1 routing with a capacity: the gate's softmax picks one
expert a token, each token's arrival position in its expert's queue comes
from an integer cumulative sum (an f32 one loses exact positions past 2^24
tokens), and tokens past the capacity ``ceil(N / E * capacity_factor)`` are
dropped to the residual (their output is 0). Dispatch, the experts' MLPs
(``silu``) and the combine are the JAX package's three einsums over dense
``(tokens, experts, capacity)`` tensors.

With ``comm`` every rank holds ``n_experts / p`` experts (its ceil-rule
chunk of the expert axis) and the same tokens: each rank routes all the
tokens, runs its own experts, and the expert outputs come together over the
ranks (an all-gather of the expert axis, whose backward hands each rank the
gradient of its own experts) before the combine, which every rank computes
whole. Without ``comm`` one rank holds every expert and the numbers are the
same.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..core.communication import TorchCommunication
from .transformer import _lecun_normal, _setup

__all__ = ["MoEMLP"]


class _GatherExperts(torch.autograd.Function):
    """All-gather of the expert axis whose consumer is replicated: the
    backward keeps this rank's block of the (identical) gradient."""

    @staticmethod
    def forward(ctx, local, comm, n_experts):
        ctx.comm, ctx.n = comm, n_experts
        return comm.allgather(local.contiguous(), 0, n_experts)

    @staticmethod
    def backward(ctx, grad):
        offset, lshape, _ = ctx.comm.chunk((ctx.n,), 0)
        return grad.narrow(0, offset, lshape[0]), None, None


def _lecun_normal_3d(shape, device, generator) -> torch.Tensor:
    """flax's ``lecun_normal`` of an ``(E, in, out)`` kernel: fan-in
    ``E * in`` (the leading axis counts as receptive field), truncated at two
    standard deviations."""
    std = math.sqrt(1.0 / (shape[0] * shape[1])) / 0.87962566103423978
    w = torch.empty(shape, dtype=torch.float32, device=device)
    nn.init.trunc_normal_(w, std=std, a=-2.0 * std, b=2.0 * std, generator=generator)
    return w


class MoEMLP(nn.Module):
    """Switch top-1 MoE feed-forward, ``(B, T, D)`` in and out.

    Parameters: ``gate`` ``(E, D)`` (torch's layout of flax's Dense kernel),
    ``w_in`` ``(E_local, D, d_ff)`` and ``w_out`` ``(E_local, d_ff, D)``, f32,
    cast to ``dtype`` in the forward; ``E_local = n_experts`` without
    ``comm``, else this rank's share (``n_experts`` must divide over the
    ranks). The weights are drawn whole from ``generator`` (seeded 0 when
    none is given), so every world holds the same experts."""

    def __init__(self, n_experts: int, d_ff: int, capacity_factor: float = 1.25,
                 comm: Optional[TorchCommunication] = None, dtype: torch.dtype = torch.float32,
                 *, d_model: int, device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        if comm is not None and n_experts % comm.size:
            raise ValueError(f"n_experts {n_experts} not divisible by mesh size {comm.size}")
        dev, gen = _setup(device, generator)
        self.n_experts, self.d_ff, self.capacity_factor = n_experts, d_ff, capacity_factor
        self.comm, self.dtype = comm, dtype
        self.gate = _lecun_normal(n_experts, d_model, dev, gen)
        w_in = _lecun_normal_3d((n_experts, d_model, d_ff), dev, gen)
        w_out = _lecun_normal_3d((n_experts, d_ff, d_model), dev, gen)
        lo, hi = self.expert_range()
        self.w_in = nn.Parameter(w_in[lo:hi].clone())
        self.w_out = nn.Parameter(w_out[lo:hi].clone())

    def expert_range(self):
        """The experts ``[lo, hi)`` this rank holds."""
        if self.comm is None:
            return 0, self.n_experts
        offset, lshape, _ = self.comm.chunk((self.n_experts,), 0)
        return offset, offset + lshape[0]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape
        n_tok, e = b * t, self.n_experts
        xt = x.reshape(n_tok, d).to(self.dtype)
        logits = F.linear(xt, self.gate.to(self.dtype))
        probs = torch.softmax(logits.float(), dim=-1)
        expert = probs.argmax(dim=-1)  # top-1; ties take the first, as jnp.argmax
        gate_w = probs.gather(-1, expert[:, None])[:, 0]

        cap = int(math.ceil(n_tok / e * self.capacity_factor))
        onehot = F.one_hot(expert, e).to(torch.int32)
        # 1-based arrival position of each token in its expert's queue
        pos = torch.cumsum(onehot, dim=0, dtype=torch.int32) * onehot
        keep = (pos > 0) & (pos <= cap)
        slot = F.one_hot(torch.clamp(pos - 1, 0, cap - 1).long(), cap).float()  # (N, E, C)
        dispatch = slot * keep[..., None].float()
        combine = dispatch * gate_w[:, None, None]

        lo, hi = self.expert_range()
        expert_in = torch.einsum("nd,nec->ecd", xt, dispatch[:, lo:hi].to(self.dtype))
        h = F.silu(torch.einsum("ecd,edf->ecf", expert_in, self.w_in.to(self.dtype)))
        expert_out = torch.einsum("ecf,efd->ecd", h, self.w_out.to(self.dtype))
        if self.comm is not None and self.comm.size > 1:
            expert_out = _GatherExperts.apply(expert_out, self.comm, e)
        out = torch.einsum("ecd,nec->nd", expert_out, combine.to(self.dtype))
        return out.reshape(b, t, d)
