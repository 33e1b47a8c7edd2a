"""The heat type hierarchy over torch dtypes.

Counterpart of ``heat_tpu/core/types.py``: the same class hierarchy
``datatype → bool / number → integer / floating / complexfloating``, each
backed here by a torch dtype (``torch_type()``). The JAX package runs with
64-bit types on, so a float64 numpy input stays float64 and promotion
follows the numpy-style lattice; ``torch.promote_types`` gives the same
answers as the JAX package for every type but ``uint16``, ``uint32`` and
``uint64``. Those three are backed by ``torch.uint16/32/64``, which torch
does not promote and for which it has little arithmetic (no CPU ``add``,
``neg`` or ``amax``); their promotion is the JAX package's, from the table
``_UNSIGNED_PROMOTION``, and an operation torch cannot compute on them
raises a ``TypeError`` that names the heat type (``_operations.py``).
"""

from __future__ import annotations

import builtins
from typing import Any, Type

import numpy as np
import torch

__all__ = [
    "datatype",
    "number",
    "integer",
    "signedinteger",
    "unsignedinteger",
    "bool",
    "bool_",
    "floating",
    "complexfloating",
    "flexible",
    "int8",
    "int16",
    "int32",
    "int64",
    "uint8",
    "uint16",
    "uint32",
    "uint64",
    "float16",
    "bfloat16",
    "float32",
    "float64",
    "complex64",
    "complex128",
    "byte",
    "short",
    "int",
    "long",
    "ubyte",
    "half",
    "float",
    "float_",
    "double",
    "cfloat",
    "csingle",
    "cdouble",
    "can_cast",
    "canonical_heat_type",
    "finfo",
    "heat_type_is_complexfloating",
    "heat_type_is_exact",
    "heat_type_is_inexact",
    "heat_type_of",
    "iinfo",
    "iscomplex",
    "isreal",
    "issubdtype",
    "promote_types",
    "result_type",
]


class datatype:
    """Generic data type; the root of the hierarchy (reference types.py:64)."""

    _torch: Any = None

    @classmethod
    def torch_type(cls) -> torch.dtype:
        if cls._torch is None:
            raise TypeError(f"abstract type {cls.__name__} has no torch equivalent")
        return cls._torch

    @classmethod
    def byte_size(cls) -> builtins.int:
        """Bytes of one element."""
        return cls.torch_type().itemsize


class bool(datatype):
    _torch = torch.bool


bool_ = bool


class number(datatype):
    pass


class integer(number):
    pass


class signedinteger(integer):
    pass


class unsignedinteger(integer):
    pass


class floating(number):
    pass


class complexfloating(number):
    pass


class flexible(datatype):
    pass


class int8(signedinteger):
    _torch = torch.int8


class int16(signedinteger):
    _torch = torch.int16


class int32(signedinteger):
    _torch = torch.int32


class int64(signedinteger):
    _torch = torch.int64


class uint8(unsignedinteger):
    _torch = torch.uint8


class uint16(unsignedinteger):
    _torch = torch.uint16


class uint32(unsignedinteger):
    _torch = torch.uint32


class uint64(unsignedinteger):
    _torch = torch.uint64


class float16(floating):
    _torch = torch.float16


class bfloat16(floating):
    _torch = torch.bfloat16


class float32(floating):
    _torch = torch.float32


class float64(floating):
    _torch = torch.float64


class complex64(complexfloating):
    _torch = torch.complex64


class complex128(complexfloating):
    _torch = torch.complex128


byte = int8
short = int16
int = int32
long = int64
ubyte = uint8
half = float16
float = float32
float_ = float32
double = float64
cfloat = complex64
csingle = complex64
cdouble = complex128

_COMPLETE_TYPES = [
    bool, int8, int16, int32, int64, uint8, uint16, uint32, uint64,
    float16, bfloat16, float32, float64, complex64, complex128,
]
_TORCH_MAP = {t._torch: t for t in _COMPLETE_TYPES}
_NAME_MAP = {str(t._torch).replace("torch.", ""): t for t in _COMPLETE_TYPES}
# python builtins map as in the JAX package: int → int64, float → float32
_ALIAS_MAP = {
    builtins.bool: bool,
    builtins.int: int64,
    builtins.float: float32,
    builtins.complex: complex64,
}


def canonical_heat_type(a_type: Any) -> Type[datatype]:
    """Canonicalize a heat type / torch dtype / numpy dtype / python type /
    string into the heat type class (reference types.py:495)."""
    if isinstance(a_type, type) and issubclass(a_type, datatype):
        return a_type
    if isinstance(a_type, torch.dtype):
        if a_type in _TORCH_MAP:
            return _TORCH_MAP[a_type]
        raise TypeError(f"data type {a_type!r} not understood")
    try:
        if a_type in _ALIAS_MAP:
            return _ALIAS_MAP[a_type]
    except TypeError:
        pass
    if isinstance(a_type, str) and a_type in _NAME_MAP:
        return _NAME_MAP[a_type]
    try:
        name = np.dtype(a_type).name
    except TypeError:
        raise TypeError(f"data type {a_type!r} not understood") from None
    if name in _NAME_MAP:
        return _NAME_MAP[name]
    raise TypeError(f"data type {a_type!r} not understood")


# The JAX package's promote_types for every pair with uint16, uint32 or
# uint64 (taken from heat_tpu.core.types.promote_types, which is jnp's
# lattice under x64), which torch.promote_types does not cover.
_FLOATS_KEPT = {"float16": "float16", "bfloat16": "bfloat16", "float32": "float32",
                "float64": "float64", "complex64": "complex64", "complex128": "complex128"}
_UNSIGNED_PROMOTION = {
    "uint16": {"bool": "uint16", "int8": "int32", "int16": "int32", "int32": "int32",
               "int64": "int64", "uint8": "uint16", "uint16": "uint16", "uint32": "uint32",
               "uint64": "uint64", **_FLOATS_KEPT},
    "uint32": {"bool": "uint32", "int8": "int64", "int16": "int64", "int32": "int64",
               "int64": "int64", "uint8": "uint32", "uint16": "uint32", "uint32": "uint32",
               "uint64": "uint64", **_FLOATS_KEPT},
    "uint64": {"bool": "uint64", "int8": "float64", "int16": "float64", "int32": "float64",
               "int64": "float64", "uint8": "uint64", "uint16": "uint64", "uint32": "uint64",
               "uint64": "uint64", **_FLOATS_KEPT},
}


def promote_types(type1: Any, type2: Any) -> Type[datatype]:
    """Smallest type to which both may be safely cast (reference
    types.py:836)."""
    t1, t2 = canonical_heat_type(type1), canonical_heat_type(type2)
    for a, b in ((t1, t2), (t2, t1)):
        if a.__name__ in _UNSIGNED_PROMOTION:
            return _NAME_MAP[_UNSIGNED_PROMOTION[a.__name__][b.__name__]]
    return canonical_heat_type(torch.promote_types(t1.torch_type(), t2.torch_type()))


def heat_type_of(obj: Any) -> Type[datatype]:
    """The heat type of an object's elements (reference types.py:284):
    python numbers map as the JAX package maps them (int to int64, float to
    float32)."""
    from .dndarray import DNDarray

    if isinstance(obj, DNDarray):
        return obj.dtype
    if isinstance(obj, (torch.Tensor, np.ndarray)) or hasattr(obj, "dtype"):
        return canonical_heat_type(obj.dtype)
    if isinstance(obj, (builtins.bool, np.bool_)):
        return bool
    if isinstance(obj, (builtins.int, builtins.float, builtins.complex)):
        return _ALIAS_MAP[type(obj)]
    try:
        return canonical_heat_type(np.asarray(obj).dtype)
    except TypeError:
        raise TypeError(f"data type of {obj!r} not understood") from None


def _kind_of(ht_dtype: Any, kinds) -> builtins.bool:
    try:
        return issubclass(canonical_heat_type(ht_dtype), kinds)
    except TypeError:
        return False


def heat_type_is_exact(ht_dtype: Any) -> builtins.bool:
    """True for the integer types and bool."""
    return _kind_of(ht_dtype, (integer, bool))


def heat_type_is_inexact(ht_dtype: Any) -> builtins.bool:
    """True for the floating and complex types."""
    return _kind_of(ht_dtype, (floating, complexfloating))


def heat_type_is_complexfloating(ht_dtype: Any) -> builtins.bool:
    return _kind_of(ht_dtype, complexfloating)


def issubdtype(arg1: Any, arg2: Any) -> builtins.bool:
    """numpy's abstract type lattice: whether ``arg1`` is ``arg2`` or below
    it."""
    return issubclass(canonical_heat_type(arg1), canonical_heat_type(arg2))


def result_type(*args: Any) -> Type[datatype]:
    """The result heat type of an operation on ``args`` (reference
    types.py:343): arrays, tensors and types join strongly, python numbers
    weakly, as the elementwise operations join them."""
    from ._operations import result_type as joined
    from .dndarray import DNDarray

    operands = []
    for a in args:
        if isinstance(a, DNDarray):
            operands.append(torch.empty(0, dtype=a.dtype.torch_type()))
        elif isinstance(a, torch.Tensor) or isinstance(a, (builtins.int, builtins.float,
                                                             builtins.complex, np.generic)):
            operands.append(a)
        else:
            try:
                t = canonical_heat_type(a)
            except TypeError:
                t = canonical_heat_type(np.asarray(a).dtype)
            operands.append(torch.empty(0, dtype=t.torch_type()))
    if not builtins.any(isinstance(o, (torch.Tensor, np.generic, builtins.bool)) for o in operands):
        # python numbers alone: the first gives its kind's 64-bit type, as in jnp
        first = {builtins.int: torch.int64, builtins.float: torch.float64,
                 builtins.complex: torch.complex128}[type(operands[0])]
        operands = [torch.empty(0, dtype=first)] + operands[1:]
    return canonical_heat_type(joined(*operands))


def can_cast(from_: Any, to: Any, casting: str = "intuitive") -> builtins.bool:
    """Whether a cast is possible under ``casting`` (reference types.py:365):
    numpy's ``'no'``, ``'safe'``, ``'same_kind'`` and ``'unsafe'``, and the
    default ``'intuitive'`` ('safe', and any integer to an inexact type,
    and bool to anything)."""
    try:
        frm = canonical_heat_type(from_) if not np.isscalar(from_) else None
    except TypeError:
        frm = None
    if frm is None:
        try:
            frm = heat_type_of(from_)
        except TypeError:
            raise TypeError(f"cannot cast from {from_!r}") from None
    to_t = canonical_heat_type(to)
    if casting == "intuitive":
        if frm is to_t or issubclass(frm, bool):
            return True
        if issubclass(frm, integer) and issubclass(to_t, (integer, floating, complexfloating)):
            return True
        casting = "safe"
    if casting not in ("no", "safe", "same_kind", "unsafe"):
        raise ValueError(
            f"casting must be one of 'no', 'safe', 'same_kind', 'unsafe', 'intuitive', "
            f"got {casting!r}")
    if frm is bfloat16 or to_t is bfloat16:  # numpy has no bfloat16: ml_dtypes' table
        if casting in ("no", "unsafe") or frm is to_t:
            return casting == "unsafe" or frm is to_t
        if frm is bfloat16:
            return to_t in (float32, float64, complex64, complex128)
        return casting == "same_kind" or frm in (bool, int8, uint8)
    return builtins.bool(np.can_cast(np.dtype(frm.__name__), np.dtype(to_t.__name__),
                                     casting=casting))


def iscomplex(x):
    """Elementwise test for a non-zero imaginary part."""
    from . import complex_math, factories, relational
    from .dndarray import DNDarray

    if not isinstance(x, DNDarray):
        x = factories.array(x)
    if issubclass(x.dtype, complexfloating):
        return relational.ne(complex_math.imag(x), 0)
    return factories.zeros(x.shape, dtype=bool, split=x.split, device=x.device, comm=x.comm)


def isreal(x):
    """Elementwise test for a zero imaginary part."""
    from . import complex_math, factories, relational
    from .dndarray import DNDarray

    if not isinstance(x, DNDarray):
        x = factories.array(x)
    if issubclass(x.dtype, complexfloating):
        return relational.eq(complex_math.imag(x), 0)
    return factories.ones(x.shape, dtype=bool, split=x.split, device=x.device, comm=x.comm)


class finfo:
    """Machine limits for floating point types (reference types.py:441)."""

    def __new__(cls, dtype):
        t = canonical_heat_type(dtype)
        if not issubclass(t, (floating, complexfloating)):
            raise TypeError(f"data type {t!r} not inexact")
        info = torch.finfo(t.torch_type())
        self = object.__new__(cls)
        self.bits = info.bits
        self.eps = builtins.float(info.eps)
        self.max = builtins.float(info.max)
        self.min = builtins.float(info.min)
        self.tiny = builtins.float(info.tiny)
        return self


class iinfo:
    """Machine limits for integer types (reference types.py:1007)."""

    def __new__(cls, dtype):
        t = canonical_heat_type(dtype)
        if not issubclass(t, integer):
            raise TypeError(f"data type {t!r} not an integer")
        info = torch.iinfo(t.torch_type())
        self = object.__new__(cls)
        self.bits, self.max, self.min = info.bits, builtins.int(info.max), builtins.int(info.min)
        return self

