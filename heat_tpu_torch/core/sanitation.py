"""Input and output validation (counterpart of
``heat_tpu/core/sanitation.py``)."""

from __future__ import annotations

from typing import Any, Union

import torch

from . import types

__all__ = [
    "sanitize_in",
    "sanitize_infinity",
    "sanitize_in_tensor",
    "sanitize_lshape",
    "sanitize_out",
    "sanitize_sequence",
    "scalar_to_1d",
]


def sanitize_in(x: Any) -> None:
    """Raise TypeError unless ``x`` is a DNDarray."""
    from .dndarray import DNDarray

    if not isinstance(x, DNDarray):
        raise TypeError(f"input needs to be a DNDarray, but was {type(x)}")


def sanitize_infinity(x) -> Union[int, float]:
    """The largest value of ``x``'s type for an integer type (a stand-in
    for +inf), else inf."""
    dtype = types.canonical_heat_type(x.dtype if hasattr(x, "dtype") else types.heat_type_of(x))
    if issubclass(dtype, types.integer):
        return types.iinfo(dtype).max
    return float("inf")


def sanitize_in_tensor(x: Any) -> None:
    """Raise TypeError unless ``x`` is a torch tensor (a rank's local
    array)."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"input needs to be a torch.Tensor, but was {type(x)}")


def sanitize_lshape(array, tensor) -> None:
    """Raise ValueError unless ``tensor`` can be a rank's chunk of
    ``array``: its shape, but for the split dimension."""
    tshape, gshape, split = tuple(tensor.shape), tuple(array.shape), array.split
    if tshape == gshape:
        return
    if split is None:
        raise ValueError(f"local tensor of shape {tshape} is not compatible with global shape {gshape}")
    if len(tshape) != len(gshape) or any(
            d != split and tshape[d] != gshape[d] for d in range(len(gshape))):
        raise ValueError(
            f"local tensor of shape {tshape} is not a valid shard of global shape {gshape} "
            f"split {split}")


def sanitize_sequence(seq: Any) -> list:
    """A list, tuple or replicated DNDarray as a python list."""
    from .dndarray import DNDarray

    if isinstance(seq, list):
        return seq
    if isinstance(seq, tuple):
        return list(seq)
    if isinstance(seq, DNDarray):
        if seq.split is None:
            return seq.tolist()
        raise ValueError(f"seq must not be distributed, got split={seq.split}")
    raise TypeError(f"seq must be a list, tuple or non-distributed DNDarray, got {type(seq)}")


def scalar_to_1d(x):
    """A 0-d DNDarray as a replicated one-element 1-D one (a 1-D one as
    itself)."""
    from .dndarray import DNDarray

    if x.ndim == 1:
        return x
    if x.ndim != 0:
        raise ValueError(f"expected a scalar DNDarray, got ndim={x.ndim}")
    return DNDarray(x.larray.reshape(1), (1,), x.dtype, None, x.device, x.comm, True)


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
