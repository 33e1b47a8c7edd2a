"""Complex number functions (counterpart of
``heat_tpu/core/complex_math.py``) on the port's ``complex64`` and
``complex128``."""

from __future__ import annotations

import torch

from . import types
from ._operations import local_op
from .dndarray import DNDarray

__all__ = ["angle", "conj", "conjugate", "imag", "real"]


def _angle(t: torch.Tensor, deg: bool) -> torch.Tensor:
    re = t.real if t.is_complex() else t
    im = t.imag if t.is_complex() else torch.zeros_like(t)
    if not re.is_floating_point() or t.ndim == 0:  # jnp's default float type
        re, im = re.to(torch.float64), im.to(torch.float64)
    res = torch.atan2(im, re)
    return torch.rad2deg(res) if deg else res


def angle(x: DNDarray, deg: bool = False, out=None) -> DNDarray:
    """The argument ``atan2(imag, real)`` of each element, in radians
    (degrees if ``deg``); exact input (and a real 0-d array) gives float64,
    as in the JAX package."""
    return local_op(lambda t: _angle(t, deg), x, out)


def conjugate(x: DNDarray, out=None) -> DNDarray:
    """Elementwise complex conjugate (real input unchanged)."""
    return local_op(torch.conj_physical, x, out)


conj = conjugate


def imag(x: DNDarray) -> DNDarray:
    """The imaginary part (zeros of the input's type for real input)."""
    if issubclass(x.dtype, types.complexfloating):
        return local_op(torch.imag, x)
    from . import factories

    return factories.zeros_like(x)


def real(x: DNDarray) -> DNDarray:
    """The real part (the input itself when it is real)."""
    if issubclass(x.dtype, types.complexfloating):
        return local_op(torch.real, x)
    return x


DNDarray.conj = lambda self, out=None: conjugate(self, out)
