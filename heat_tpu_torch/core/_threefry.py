"""Counter-mode threefry2x32 in plain torch: the JAX package's random bits.

The JAX package draws every random array with ``jax.random`` under
``jax_threefry_partitionable`` (the default): the 32 bits of the element at
flat index ``i`` of the global shape are ``x0 ^ x1`` with
``(x0, x1) = threefry2x32(key, (i >> 32, i & 0xffffffff))``, so they depend
on the key and ``i`` alone. A rank draws its own chunk of a split array
without drawing the rest, and the result does not depend on the number of
ranks. This module reproduces that stream and the transforms of
``jax/_src/random.py`` on top of it, bit for bit where the arithmetic is
exact:

* :func:`threefry2x32`: the Threefry-2x32 hash with 20 rounds, the rotation
  schedule and key injections of ``jax/_src/prng.py`` (``apply_round``,
  ``_threefry2x32_lowering``);
* :func:`prng_key`, :func:`fold_in`, :func:`split`: keys as pairs of
  python ints (``threefry_seed``, ``threefry_fold_in`` and the fold-like
  ``split``);
* :func:`draw_plain`: the raw draws of a rank's :class:`Slice` of a global
  shape: ``bits32``, ``bits64`` (the high word shifted left 32, OR the low
  word), ``uniform_f32`` and ``normal_f32``. These four are what the CUDA
  kernel computes (``cuda_random.draw``); this is its plain version and the
  path on the CPU;
* the transforms :func:`uniform`, :func:`normal`, :func:`randint`,
  :func:`permutation` and :func:`choice` over a ``draw`` function
  (``_uniform``, ``_normal_real``, ``_randint``, ``_shuffle`` and ``choice``
  of ``jax/_src/random.py``).

``normal`` inverts the error function with the polynomials that XLA lowers
``erf_inv`` to (Giles' single-precision one for float32, the three-branch
one for float64), never with ``torch.erfinv``. It agrees with the JAX
package's draw to 3 ulp, not bit for bit: the float32 polynomial starts
from torch's ``log1p``, whose last bits differ from XLA's (XLA's own
float32 ``log1p`` changes with its optimisation level), the float64 one
from XLA's ``log1p`` (:func:`log1p_xla`).

Words are kept in int32 tensors (the same bits as uint32; additions wrap,
right shifts are masked) because torch has no CPU shift for uint32.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "EPILOGUES",
    "Slice",
    "choice",
    "draw_plain",
    "erfinv_f32",
    "erfinv_f64",
    "fold_in",
    "normal",
    "permutation",
    "prng_key",
    "randint",
    "split",
    "threefry2x32",
    "threefry2x32_int",
    "uniform",
]

M32 = 0xFFFFFFFF
M64 = 0xFFFFFFFFFFFFFFFF
# rotation amounts and the key-schedule parity (jax/_src/prng.py)
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
PARITY = 0x1BD11BDA
EPILOGUES = ("bits32", "bits64", "uniform_f32", "normal_f32")
# the lower bound of the uniform draw that feeds erfinv: nextafter(-1, 0)
NORMAL_LO_F32 = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
NORMAL_LO_F64 = float(np.nextafter(-1.0, 0.0))
SQRT2_F32 = float(np.float32(np.sqrt(2.0)))
SQRT2_F64 = float(np.sqrt(2.0))

Key = Tuple[int, int]

# XLA's erf_inv for float32 (Giles): w < 5 and w >= 5 branches
ERFINV_F32_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                  0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
ERFINV_F32_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                  0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)
# XLA's erf_inv for float64: w < 6.25, w < 16 and w >= 16 branches
ERFINV_F64_LT625 = (
    -3.6444120640178196996e-21, -1.685059138182016589e-19, 1.2858480715256400167e-18,
    1.115787767802518096e-17, -1.333171662854620906e-16, 2.0972767875968561637e-17,
    6.6376381343583238325e-15, -4.0545662729752068639e-14, -8.1519341976054721522e-14,
    2.6335093153082322977e-12, -1.2975133253453532498e-11, -5.4154120542946279317e-11,
    1.051212273321532285e-09, -4.1126339803469836976e-09, -2.9070369957882005086e-08,
    4.2347877827932403518e-07, -1.3654692000834678645e-06, -1.3882523362786468719e-05,
    0.0001867342080340571352, -0.00074070253416626697512, -0.0060336708714301490533,
    0.24015818242558961693, 1.6536545626831027356)
ERFINV_F64_LT16 = (
    2.2137376921775787049e-09, 9.0756561938885390979e-08, -2.7517406297064545428e-07,
    1.8239629214389227755e-08, 1.5027403968909827627e-06, -4.013867526981545969e-06,
    2.9234449089955446044e-06, 1.2475304481671778723e-05, -4.7318229009055733981e-05,
    6.8284851459573175448e-05, 2.4031110387097893999e-05, -0.0003550375203628474796,
    0.00095328937973738049703, -0.0016882755560235047313, 0.0024914420961078508066,
    -0.0037512085075692412107, 0.005370914553590063617, 1.0052589676941592334,
    3.0838856104922207635)
ERFINV_F64_GE16 = (
    -2.7109920616438573243e-11, -2.5556418169965252055e-10, 1.5076572693500548083e-09,
    -3.7894654401267369937e-09, 7.6157012080783393804e-09, -1.4960026627149240478e-08,
    2.9147953450901080826e-08, -6.7711997758452339498e-08, 2.2900482228026654717e-07,
    -9.9298272942317002539e-07, 4.5260625972231537039e-06, -1.9681778105531670567e-05,
    7.5995277030017761139e-05, -0.00021503011930044477347, -0.00013871931833623122026,
    1.0103004648645343977, 4.8499064014085844221)


def _s32(v: int) -> int:
    """A python int as the int32 with the same low 32 bits."""
    v &= M32
    return v - (1 << 32) if v >= 1 << 31 else v


def _s64(v: int) -> int:
    """A python int as the int64 with the same low 64 bits."""
    v &= M64
    return v - (1 << 64) if v >= 1 << 63 else v


# ------------------------------------------------------------------ the hash


def threefry2x32_int(k0: int, k1: int, x0: int, x1: int) -> Tuple[int, int]:
    """Threefry-2x32 (20 rounds) of one counter pair, on python ints."""
    ks = (k0 & M32, k1 & M32, (k0 ^ k1 ^ PARITY) & M32)
    x0, x1 = (x0 + ks[0]) & M32, (x1 + ks[1]) & M32
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & M32) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


def threefry2x32(k0: int, k1: int, x0: torch.Tensor, x1: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 (20 rounds) of the counter words ``x0``, ``x1`` (int32
    tensors holding uint32 bits) under the key ``(k0, k1)``; returns the
    two int32 output words. The inputs are not modified."""
    ks = (k0 & M32, k1 & M32, (k0 ^ k1 ^ PARITY) & M32)
    x0 = x0 + _s32(ks[0])
    x1 = x1 + _s32(ks[1])
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 += x1
            x1 = (x1 << r).bitwise_or_((x1 >> (32 - r)).bitwise_and_((1 << r) - 1))
            x1 ^= x0
        x0 += _s32(ks[(i + 1) % 3])
        x1 += _s32(ks[(i + 2) % 3] + i + 1)
    return x0, x1


# ------------------------------------------------------------------ the keys


def prng_key(seed: int) -> Key:
    """``PRNGKey(seed)``: the seed's 64 bits as (high word, low word)."""
    seed = int(seed) & M64
    return (seed >> 32) & M32, seed & M32


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in``: the key hashed with the counter (0, data)."""
    return threefry2x32_int(key[0], key[1], 0, int(data) & M32)


def split(key: Key, num: int = 2) -> Tuple[Key, ...]:
    """``jax.random.split`` in its fold-like form: key ``i`` is
    ``fold_in(key, i)``."""
    return tuple(fold_in(key, i) for i in range(num))


# ------------------------------------------------------------- the counters


@dataclass(frozen=True)
class Slice:
    """A rank's part of a global shape: the whole of it when ``split`` is
    None, else the ``length`` entries from ``start`` along ``split``. The
    element ``(outer, start + s, inner)`` takes the counter
    ``((outer * G) + start + s) * inner_size + inner``, ``G`` the global
    length of the split axis."""

    gshape: Tuple[int, ...]
    split: Optional[int] = None
    start: int = 0
    length: Optional[int] = None

    @staticmethod
    def whole(shape: Sequence[int]) -> "Slice":
        return Slice(tuple(int(s) for s in shape))

    @property
    def shape(self) -> Tuple[int, ...]:
        if self.split is None:
            return self.gshape
        s = self.split
        return self.gshape[:s] + (self._length(),) + self.gshape[s + 1:]

    def _length(self) -> int:
        return self.gshape[self.split] - self.start if self.length is None else self.length

    @property
    def numel(self) -> int:
        return math.prod(self.shape)

    def layout(self) -> Tuple[int, int, int, int, int]:
        """(outer, G, inner, start, length): the local flat index
        ``(o * length + t) * inner + i`` takes the counter
        ``((o * G) + start + t) * inner + i``."""
        if self.split is None:
            n = math.prod(self.gshape)
            return 1, n, 1, 0, n
        s = self.split
        outer = math.prod(self.gshape[:s])
        inner = math.prod(self.gshape[s + 1:])
        return outer, self.gshape[s], inner, self.start, self._length()

    def counters(self, device) -> torch.Tensor:
        """The global flat index of every local element, int64, in the
        local shape."""
        outer, g, inner, start, length = self.layout()
        if outer == 1:
            idx = torch.arange(start * inner, (start + length) * inner, dtype=torch.int64,
                               device=device)
        else:
            o = torch.arange(outer, dtype=torch.int64, device=device) * (g * inner)
            t = torch.arange(start, start + length, dtype=torch.int64, device=device) * inner
            i = torch.arange(inner, dtype=torch.int64, device=device)
            idx = (o[:, None, None] + t[None, :, None] + i[None, None, :]).reshape(-1)
        return idx.reshape(self.shape)


def _words(key: Key, sl: Slice, device) -> Tuple[torch.Tensor, torch.Tensor]:
    idx = sl.counters(device)
    hi = (idx >> 32).to(torch.int32)
    lo = idx.to(torch.int32)  # the low 32 bits
    del idx
    return threefry2x32(key[0], key[1], hi, lo)


# --------------------------------------------------------------- raw draws


def _u01_f32(bits: torch.Tensor) -> torch.Tensor:
    """float32 in [0, 1) from 32 random bits: the 23 high bits as the
    mantissa of a number in [1, 2), minus 1."""
    mant = (bits >> 9).bitwise_and_(0x7FFFFF).bitwise_or_(0x3F800000)
    return mant.view(torch.float32) - 1.0


def _scaled(floats: torch.Tensor, lo, hi) -> torch.Tensor:
    """``max(lo, floats * (hi - lo) + lo)`` in the type of ``floats``: the
    product and the sum each rounded (no fused multiply-add)."""
    dt = floats.dtype
    lo_t = torch.as_tensor(lo, dtype=dt, device=floats.device)
    hi_t = torch.as_tensor(hi, dtype=dt, device=floats.device)
    return torch.maximum(lo_t, floats * (hi_t - lo_t) + lo_t)


# the rational approximation of log1p that XLA uses for |x| < sqrt(2) - 1
# (Cephes), numerator and denominator from the highest power down
LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
             6.5787325942061044846969e0, 2.9911919328553073277375e1,
             6.0949667980987787057556e1, 5.7112963590585538103336e1,
             2.0039553499201281259648e1)
LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
             2.2176239823732856465394e2, 3.0909872225312059774938e2,
             2.1642788614495947685003e2, 6.0118660497603843919306e1)
LOG1P_SMALL = 0.41421356237309504880


def log1p_xla(x: torch.Tensor) -> torch.Tensor:
    """XLA's float64 ``log1p``: ``x - x^2/2 + x^3 P(x)/Q(x)`` for
    ``|x| < sqrt(2) - 1``, ``log(1 + x)`` elsewhere. Its last bits differ
    from ``torch.log1p``'s, and ``erf_inv`` magnifies them in the float64
    normal draw; with it the draw is within 3 ulp of the JAX package's."""
    x2 = x * x
    num = torch.full_like(x, LOG1P_NUM[0])
    den = torch.full_like(x, LOG1P_DEN[0])
    for c_num, c_den in zip(LOG1P_NUM[1:], LOG1P_DEN[1:]):
        num = num * x + c_num
        den = den * x + c_den
    small = x + (-0.5 * x2 + (x * x2) * (num / den))
    return torch.where(x.abs() < LOG1P_SMALL, small, torch.log(1 + x))


def erfinv_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv``: ``w = -log1p(-x^2)``, a nine-term
    polynomial in ``w - 2.5`` (w < 5) or ``sqrt(w) - 3``, times ``x``;
    ``erf_inv(+-1) = +-inf``."""
    w = -torch.log1p(x * -x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    c_lt = torch.tensor(ERFINV_F32_LT5, dtype=torch.float32, device=x.device)
    c_ge = torch.tensor(ERFINV_F32_GE5, dtype=torch.float32, device=x.device)
    p = torch.where(lt, c_lt[0], c_ge[0])
    for i in range(1, 9):
        p = torch.where(lt, c_lt[i], c_ge[i]) + p * w
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


def erfinv_f64(x: torch.Tensor) -> torch.Tensor:
    """XLA's float64 ``erf_inv``: three branches of ``w = -log1p(-x^2)``
    (w < 6.25, w < 16, else) with 23, 19 and 17 coefficients."""
    w = -log1p_xla(x * -x)
    lt625 = w < 6.25
    lt16 = w < 16.0
    dev = x.device
    c625 = torch.tensor(ERFINV_F64_LT625, dtype=torch.float64, device=dev)
    c16 = torch.tensor(ERFINV_F64_LT16, dtype=torch.float64, device=dev)
    cge = torch.tensor(ERFINV_F64_GE16, dtype=torch.float64, device=dev)

    def coefficient(i):
        c = c625[i]
        if i < 19:
            c = torch.where(lt625, c, c16[i])
        if i < 17:
            c = torch.where(lt16, c, cge[i])
        return c

    w = torch.where(lt625, w - 3.125, torch.sqrt(w) - torch.where(lt16, 3.25, 5.0))
    p = coefficient(0)
    for i in range(1, 17):
        p = coefficient(i) + p * w
    for i in range(17, 19):
        p = torch.where(lt16, coefficient(i) + p * w, p)
    for i in range(19, 23):
        p = torch.where(lt625, coefficient(i) + p * w, p)
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


def draw_plain(key: Key, sl: Slice, epilogue: str, lo: float = 0.0, hi: float = 1.0,
               device="cpu") -> torch.Tensor:
    """The raw draw ``epilogue`` of the slice ``sl`` under ``key``, in
    plain torch on ``device``:

    * ``bits32``: int32, the bits ``x0 ^ x1`` (uint32 in the JAX package);
    * ``bits64``: int64, ``x0 << 32 | x1``;
    * ``uniform_f32``: float32 in [lo, hi) (``jax.random.uniform``);
    * ``normal_f32``: float32 standard normal (``jax.random.normal``).
    """
    if epilogue not in EPILOGUES:
        raise ValueError(f"unknown epilogue {epilogue!r}; one of {EPILOGUES}")
    x0, x1 = _words(key, sl, device)
    if epilogue == "bits64":
        return (x0.to(torch.int64) << 32) | (x1.to(torch.int64) & M32)
    bits = x0.bitwise_xor_(x1)
    del x1
    if epilogue == "bits32":
        return bits
    if epilogue == "uniform_f32":
        return _scaled(_u01_f32(bits), lo, hi)
    u = _scaled(_u01_f32(bits), NORMAL_LO_F32, 1.0)
    return SQRT2_F32 * erfinv_f32(u)


# -------------------------------------------------------------- transforms

Draw = Callable[..., torch.Tensor]


def _u01(draw: Draw, key: Key, sl: Slice, dtype: torch.dtype, device) -> torch.Tensor:
    """``[0, 1)`` in ``dtype`` by the mantissa rule of ``_uniform``."""
    if dtype == torch.float64:
        bits = draw(key, sl, "bits64", device=device)
        mant = ((bits >> 12) & ((1 << 52) - 1)) | 0x3FF0000000000000
        return mant.view(torch.float64) - 1.0
    if dtype == torch.float32:
        return _u01_f32(draw(key, sl, "bits32", device=device))
    if dtype in (torch.float16, torch.bfloat16):
        # float16 takes 16 random bits, bfloat16 (7 mantissa bits) 8: the
        # low bits of the 32-bit draw
        rng_bits, nmant, one = (16, 10, 0x3C00) if dtype == torch.float16 else (8, 7, 0x3F80)
        low = draw(key, sl, "bits32", device=device) & ((1 << rng_bits) - 1)
        mant = ((low >> (rng_bits - nmant)) | one).to(torch.int16)
        return mant.view(dtype) - 1.0
    raise TypeError(f"uniform only accepts floating point types, got {dtype}")


def uniform(key: Key, sl: Slice, dtype: torch.dtype, minval=0.0, maxval=1.0,
            draw: Draw = draw_plain, device="cpu") -> torch.Tensor:
    """``jax.random.uniform`` of the slice: scalar bounds in float32 are the
    ``uniform_f32`` draw; other types and array bounds (tensors of the
    local shape or broadcastable to it) transform the raw bits here."""
    scalar = not (isinstance(minval, torch.Tensor) and minval.ndim) and not (
        isinstance(maxval, torch.Tensor) and maxval.ndim)
    if dtype == torch.float32 and scalar:
        return draw(key, sl, "uniform_f32", float(minval), float(maxval), device=device)
    return _scaled(_u01(draw, key, sl, dtype, device), minval, maxval)


def normal(key: Key, sl: Slice, dtype: torch.dtype, draw: Draw = draw_plain,
           device="cpu") -> torch.Tensor:
    """``jax.random.normal`` of the slice: ``sqrt(2) * erf_inv(u)`` with
    ``u`` uniform in (-1, 1). float32 is the ``normal_f32`` draw; float64
    takes the 64-bit bits and the float64 polynomial; float16 and bfloat16
    compute ``erf_inv`` in float32, as XLA does."""
    if dtype == torch.float32:
        return draw(key, sl, "normal_f32", device=device)
    if dtype == torch.float64:
        u = _scaled(_u01(draw, key, sl, dtype, device), NORMAL_LO_F64, 1.0)
        return SQRT2_F64 * erfinv_f64(u)
    if dtype in (torch.float16, torch.bfloat16):
        lo = float(np.nextafter(np.array(-1.0, np.float16), np.float16(0))) \
            if dtype == torch.float16 else -float.fromhex("0x1.fep-1")
        u = _scaled(_u01(draw, key, sl, dtype, device), lo, 1.0)
        return torch.tensor(SQRT2_F64, dtype=dtype) * erfinv_f32(u.float()).to(dtype)
    raise TypeError(f"normal only accepts floating point types, got {dtype}")


def _unsigned_ge(a: torch.Tensor, b: int) -> torch.Tensor:
    """``a >= b`` for int64 ``a`` read as uint64 and a python ``b`` in
    [0, 2^64)."""
    flip = -(1 << 63)
    return (a ^ flip) >= _s64(b ^ (1 << 63))


def _urem64(x: torch.Tensor, span: int) -> torch.Tensor:
    """``x mod span`` for int64 ``x`` read as uint64 and a python span in
    [0, 2^64) (0 stands for 2^64: the remainder is ``x``), as int64 bits."""
    if span == 0:
        return x
    if span & (span - 1) == 0:
        return x & _s64(span - 1)
    if span >= 1 << 63:
        return torch.where(_unsigned_ge(x, span), x - _s64(span), x)
    half = (x >> 1) & ((1 << 63) - 1)  # x // 2, non-negative
    t = torch.remainder(half, span) * 2 + (x & 1)  # < 2 span, uint64 bits
    return torch.where(_unsigned_ge(t, span), t - _s64(span), t)


def _clip(v: int, dtype: torch.dtype) -> int:
    info = torch.iinfo(dtype)
    return min(max(int(v), info.min), info.max)


def randint(key: Key, sl: Slice, minval: int, maxval: int, dtype: torch.dtype,
            draw: Draw = draw_plain, device="cpu") -> torch.Tensor:
    """``jax.random.randint`` of the slice for python bounds: 8- and 16-bit
    types sample in int32 (bounds clipped to the type) and are cast; two
    draws of the type's width under ``split(key)``, the offset
    ``(hi mod span) * (2^(w/2) mod span)^2 + lo mod span`` in unsigned
    ``w``-bit arithmetic, mod ``span``; a ``maxval`` above the type's range
    widens the span by one."""
    if dtype.is_floating_point or dtype.is_complex or dtype == torch.bool:
        raise TypeError(f"randint only accepts integer types, got {dtype}")
    info = torch.iinfo(dtype)
    sample = dtype
    minval, maxval = int(minval), int(maxval)
    if info.bits < 32:
        sample = torch.int32
        minval = min(max(_s32(minval), info.min), info.max)
        maxval = min(max(_s32(maxval), info.min), info.max + 1)
    sinfo = torch.iinfo(sample)
    nbits = sinfo.bits
    mask = (1 << nbits) - 1
    out_of_range = maxval > sinfo.max
    minval, maxval = _clip(minval, sample), _clip(maxval, sample)
    span = (maxval - minval) & mask
    if maxval <= minval:
        span = 1
    if out_of_range and maxval > minval:
        span = (span + 1) & mask

    def urem(v, n):  # XLA's unsigned remainder: by 0 it is v
        return v if n == 0 else v % n

    half = 1 << (nbits // 2)
    mult = urem(half, span)
    mult = urem((mult * mult) & mask, span)
    k1, k2 = split(key)
    if nbits == 32:
        hi = draw(k1, sl, "bits32", device=device).to(torch.int64) & M32
        lo = draw(k2, sl, "bits32", device=device).to(torch.int64) & M32
        if span:  # a span of 0 stands for 2^32: every remainder is the value
            hi, lo = hi % span, lo % span
        off = (((hi * mult) & M32) + lo) & M32  # uint32 products and sums wrap
        if span:
            off = off % span
        res = (off + minval) & M32
        res = torch.where(res >= 1 << 31, res - (1 << 32), res) if sinfo.min < 0 else res
    else:
        hi = _urem64(draw(k1, sl, "bits64", device=device), span)
        lo = _urem64(draw(k2, sl, "bits64", device=device), span)
        off = _urem64(hi * _s64(mult) + lo, span)
        res = off + _s64(minval)  # wraps as the uint64/int64 add does
    return res.to(dtype)


def _sort_keys(draw: Draw, key: Key, n: int, device) -> torch.Tensor:
    """32-bit sort keys as int32 in the order of their unsigned values."""
    return draw(key, Slice.whole((n,)), "bits32", device=device) ^ _s32(1 << 31)


def permutation(key: Key, n: int, device="cpu", draw: Draw = draw_plain) -> torch.Tensor:
    """``jax.random.permutation(key, n)``: ``arange(n)`` (int64) shuffled by
    ``ceil(3 ln n / ln(2^32 - 1))`` rounds of a stable sort by fresh 32-bit
    keys (``_shuffle``)."""
    x = torch.arange(n, dtype=torch.int64, device=device)
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))
    for _ in range(rounds):
        key, sub = split(key)
        order = torch.sort(_sort_keys(draw, sub, n, device), stable=True).indices
        x = x[order]
    return x


def choice(key: Key, n: int, shape: Sequence[int] = (), replace: bool = True,
           p: Optional[torch.Tensor] = None, device="cpu", draw: Draw = draw_plain
           ) -> torch.Tensor:
    """``jax.random.choice(key, n, shape, replace, p)`` for an int ``n``:
    without replacement and without ``p`` the first draws of
    :func:`permutation`; with ``p`` and replacement ``searchsorted`` of
    ``p_cuml[-1] * (1 - uniform)`` in ``p_cuml = cumsum(p)``; without
    either, :func:`randint` in [0, n). Indices are int64."""
    shape = tuple(int(s) for s in shape)
    k = math.prod(shape)
    if k == 0:
        return torch.zeros(shape, dtype=torch.int64, device=device)
    if n <= 0:
        raise ValueError("a must be greater than 0 unless no samples are taken")
    if not replace and k > n:
        raise ValueError(f"Cannot take a larger sample (size {k}) than population (size {n}) "
                         f"when 'replace=False'")
    if p is None:
        if replace:
            return randint(key, Slice.whole(shape), 0, n, torch.int64, draw, device)
        return permutation(key, n, device, draw)[:k].reshape(shape)
    if not replace:
        raise NotImplementedError("choice with p and replace=False (the Gumbel top-k draw)")
    if tuple(p.shape) != (n,):
        raise ValueError(f"p must be None or a 1D vector with the same size as a.shape[axis]. "
                         f"p has shape {tuple(p.shape)} and a.shape[axis] is {n}.")
    if not p.is_floating_point():
        p = p.to(torch.float64 if p.dtype == torch.int64 else torch.float32)
    p_cuml = torch.cumsum(p, 0)
    u = uniform(key, Slice.whole(shape), p_cuml.dtype, draw=draw, device=device)
    r = p_cuml[-1] * (1 - u)
    return torch.searchsorted(p_cuml, r.reshape(-1)).reshape(shape).to(torch.int64)
