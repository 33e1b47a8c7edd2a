"""Functional nn operations: the distributed attention entry point, the
affine layer on DNDarrays, and a fall-through to ``torch.nn.functional``.

Counterpart of ``heat_tpu/nn/functional.py``. The reference Heat's
``heat.nn.functional`` forwards to ``torch.nn.functional``, and so does
this module for every name it does not define (``relu``, ``gelu``,
``softmax``, ``one_hot``, ...); the JAX package forwards to ``jax.nn``.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from ..core.dndarray import DNDarray
from ..parallel import local_attention, ring_attention, ulysses_attention

__all__ = ["dense", "scaled_dot_product_attention"]


def dense(x: DNDarray, w: DNDarray, bias=None, activation=None) -> DNDarray:
    """Affine layer ``activation(x @ w + bias)`` on DNDarrays, in the
    package's own operations (``matmul``, ``add`` and the activation's).

    ``activation`` is None, ``"relu"``, ``"tanh"``, ``"sigmoid"`` (as
    ``1 / (1 + exp(-y))``, the JAX package's composition) or a callable
    taking and returning a DNDarray."""
    from ..core import arithmetics, exponential, statistics, trigonometrics
    from ..core.linalg import matmul

    y = matmul(x, w)
    if bias is not None:
        y = arithmetics.add(y, bias)
    if activation is None:
        return y
    if callable(activation):
        return activation(y)
    if activation == "relu":
        return statistics.maximum(y, 0.0)
    if activation == "tanh":
        return trigonometrics.tanh(y)
    if activation == "sigmoid":
        return arithmetics.div(1.0, arithmetics.add(exponential.exp(arithmetics.mul(y, -1.0)),
                                                    1.0))
    raise ValueError(
        f"activation must be None, 'relu', 'tanh', 'sigmoid' or a callable, got {activation!r}")


def _pad_seq(local: torch.Tensor, length: int) -> torch.Tensor:
    if local.shape[1] == length:
        return local
    pad = local.new_zeros((local.shape[0], length - local.shape[1]) + tuple(local.shape[2:]))
    return torch.cat([local, pad], dim=1)


def scaled_dot_product_attention(
    q: Union[torch.Tensor, DNDarray],
    k: Union[torch.Tensor, DNDarray],
    v: Union[torch.Tensor, DNDarray],
    *,
    causal: bool = False,
    scale: Optional[float] = None,
    strategy: str = "auto",
    comm=None,
) -> Union[torch.Tensor, DNDarray]:
    """softmax(Q K^T / sqrt(d)) V in the ``(batch, seq, heads, head_dim)``
    layout.

    DNDarrays split along the sequence (axis 1) over several ranks run the
    sequence-parallel attention: ``strategy`` ``"ring"`` (any head count),
    ``"ulysses"`` (heads divisible by the ranks) or ``"auto"``, which takes
    ulysses when it applies. Each rank's chunk is zero-padded to the ceil
    rule's chunk length for the call and the pads are masked (``seq_len``).
    Replicated DNDarrays, one rank, and plain tensors run the blockwise
    ``local_attention``."""
    if strategy not in ("auto", "ring", "ulysses"):
        raise ValueError(f"strategy must be 'auto', 'ring' or 'ulysses', got {strategy!r}")
    if not isinstance(q, DNDarray):
        return local_attention(q, k, v, causal=causal, scale=scale)
    if not (isinstance(k, DNDarray) and isinstance(v, DNDarray)):
        raise TypeError("q, k, v must all be DNDarray or all torch.Tensor")
    if not (q.split == k.split == v.split):
        raise ValueError(f"q/k/v splits must match, got {q.split}/{k.split}/{v.split}")
    if q.ndim != 4:
        raise ValueError(f"expected (B, T, H, D) inputs, got ndim={q.ndim}")
    comm = q.comm
    if q.split == 1 and comm.size > 1:
        seq_len, h = q.shape[1], q.shape[2]
        if strategy == "auto":
            strategy = "ulysses" if h % comm.size == 0 else "ring"
        fn = {"ring": ring_attention, "ulysses": ulysses_attention}[strategy]
        c = comm.chunk_size(seq_len)
        out = fn(*(_pad_seq(t.larray, c) for t in (q, k, v)), comm=comm, causal=causal,
                 scale=scale, seq_len=seq_len)
        out = out[:, :q.lshape[1]]
        return DNDarray(out, q.shape, q.dtype, q.split, q.device, comm, True)
    if q.split not in (None, 1):
        raise NotImplementedError(f"attention over split={q.split} not supported; resplit to 1")
    out = local_attention(q.larray, k.larray, v.larray, causal=causal, scale=scale)
    return DNDarray(out, q.shape, q.dtype, q.split, q.device, comm, True)


def __getattr__(name):
    """torch.nn.functional fall-through (reference heat/nn/functional.py)."""
    try:
        return getattr(torch.nn.functional, name)
    except AttributeError:
        raise AttributeError(
            f"function {name} not implemented in torch.nn.functional or "
            f"heat_tpu_torch.nn.functional") from None
