"""Input and output validation (counterpart of
``heat_tpu/core/sanitation.py``, the subset this package uses)."""

from __future__ import annotations

from typing import Any

__all__ = ["sanitize_in", "sanitize_out"]


def sanitize_in(x: Any) -> None:
    """Raise TypeError unless ``x`` is a DNDarray."""
    from .dndarray import DNDarray

    if not isinstance(x, DNDarray):
        raise TypeError(f"input needs to be a DNDarray, but was {type(x)}")


def sanitize_out(out, output_shape, output_split, output_device) -> None:
    """Validate an ``out`` buffer's metadata against the expected result."""
    from .dndarray import DNDarray

    if not isinstance(out, DNDarray):
        raise TypeError(f"expected out buffer to be a DNDarray but was {type(out)}")
    if tuple(out.shape) != tuple(output_shape):
        raise ValueError(f"Expecting output buffer of shape {tuple(output_shape)}, got {out.shape}")
    if out.split != output_split:
        raise ValueError(f"Expecting output buffer with split {output_split}, got {out.split}")
    if output_device is not None and out.device != output_device:
        raise ValueError(f"Device mismatch: out is on {out.device}, expected {output_device}")
