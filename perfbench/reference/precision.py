"""The precisions the references compute in."""

import torch


def tf32(v: torch.Tensor) -> torch.Tensor:
    """Float32 ``v`` rounded to TF32 (10 mantissa bits, to nearest, ties away
    from zero, as ``cvt.rna.tf32.f32``): the operand a TF32 tensor-core
    product reads. Applied to both operands of an f32 product, it gives the
    TF32 product on any device."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def matmul_t(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """``a @ b.T`` in ``precision``: ``"f32"`` (TF32 off), ``"tf32"`` (both
    operands rounded to TF32, then an f32 product) or ``"f64"``."""
    if precision == "f64":
        return a.double() @ b.double().T
    if precision == "tf32":
        a, b = tf32(a.float()), tf32(b.float())
    elif precision != "f32":
        raise ValueError(f"precision must be 'f32', 'tf32' or 'f64', got {precision!r}")
    flag = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return a.float() @ b.float().T
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag
