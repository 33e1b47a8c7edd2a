"""Pseudo-random number generation (counterpart of
``heat_tpu/core/random.py``).

The JAX package keeps a global ``(seed, counter)`` pair and draws each call
from the key ``fold_in(PRNGKey(seed), counter)`` with ``jax.random``; the
counter then advances by one. This module keeps the same state and the same
keys and reproduces ``jax.random``'s counter-mode threefry2x32 stream and
transforms (:mod:`._threefry`), so the same seed and call sequence give the
JAX package's arrays: bit for bit for ``rand``, ``uniform``,
``random_sample`` and its aliases, ``randint``, ``randperm`` and
``permutation``; within 3 ulp for ``randn``, ``normal`` and
``standard_normal`` (the error function's inverse is the polynomial XLA
uses, not bit for bit).

Each rank draws only its own chunk of a split array (the ceil rule of
``communication.chunk``): an element's bits depend on its flat index in the
global shape alone, so no rank draws the global array and the result does
not depend on the number of ranks. ``randperm`` and ``permutation(n)`` draw
the index vector on every rank, as the JAX package does. On the card the
draws are the threefry kernel (:mod:`.cuda_random`).
"""

from __future__ import annotations

import builtins
import time
from typing import Optional, Tuple, Type, Union

import numpy as np
import torch

from . import _threefry, cuda_random, types
from .communication import get_comm, sanitize_comm
from .devices import sanitize_device
from .dndarray import DNDarray
from .stride_tricks import sanitize_axis, sanitize_shape

__all__ = [
    "get_state",
    "normal",
    "permutation",
    "rand",
    "ranf",
    "randint",
    "random_integer",
    "randn",
    "random",
    "random_sample",
    "randperm",
    "sample",
    "seed",
    "set_state",
    "standard_normal",
    "uniform",
]

# global generator state (the JAX package's random.py:47-49)
__seed: int = 0
__counter: int = 0


def _next_key() -> _threefry.Key:
    """One fresh key per draw: the call counter folded into the seed's key."""
    global __counter
    key = _threefry.fold_in(_threefry.prng_key(__seed), __counter)
    __counter += 1
    return key


def get_state() -> Tuple[str, int, int, int, float]:
    """The state tuple ``('Threefry', seed, counter, 0, 0.0)``."""
    return ("Threefry", __seed, __counter, 0, 0.0)


def set_state(state: Tuple) -> None:
    """Restore the generator state from a 3- or 5-tuple of
    :func:`get_state`'s form."""
    global __seed, __counter
    if not isinstance(state, tuple) or len(state) not in (3, 5):
        raise ValueError("state needs to be a 3- or 5-tuple")
    if state[0] != "Threefry":
        raise ValueError("algorithm must be 'Threefry'")
    __seed = builtins.int(state[1])
    __counter = builtins.int(state[2])


def seed(seed: Optional[int] = None) -> None:
    """(Re-)seed the global generator; the counter restarts at 0. Without a
    seed rank 0's wall-clock milliseconds are taken and handed to every rank
    of the default communicator, so all ranks draw from one stream."""
    global __seed, __counter
    if seed is None:
        seed = get_comm().allgather_object(int(time.time() * 1000) & 0x7FFFFFFF)[0]
    __seed = builtins.int(seed)
    __counter = 0


def _generate(shape, split, device, comm, dtype, make) -> DNDarray:
    """A DNDarray of the global ``shape`` whose local chunk is
    ``make(slice, torch device, slices)``: this rank's part only."""
    device = sanitize_device(device)
    comm = sanitize_comm(comm)
    gshape = tuple(shape)
    split = sanitize_axis(gshape, split) if gshape else None
    offset, lshape, slices = comm.chunk(gshape, split)
    sl = _threefry.Slice(gshape, split, offset, lshape[split]) if split is not None \
        else _threefry.Slice.whole(gshape)
    data = make(sl, device.torch_device, slices)
    return DNDarray(data, gshape, dtype, split, device, comm, True)


def _local(value, gshape, slices, dtype: torch.dtype, tdev):
    """A scalar bound as a python number, an array bound broadcast to the
    global shape and cut to this rank's chunk."""
    arr = np.asarray(value.numpy() if isinstance(value, DNDarray) else value)
    if arr.ndim == 0:
        return arr.item()
    whole = np.broadcast_to(arr, gshape)[slices] if gshape else arr
    return torch.tensor(np.array(whole), device=tdev).to(dtype)


def _float_type(dtype):
    dtype = types.canonical_heat_type(dtype)
    if not issubclass(dtype, types.floating):
        raise ValueError("dtype must be a float type")
    return dtype


def _shape_of(shape) -> Tuple[int, ...]:
    if shape is None or shape == ():
        return ()
    return sanitize_shape(shape)


def normal(mean=0.0, std=1.0, shape=None, dtype=types.float32, split=None, device=None,
           comm=None) -> DNDarray:
    """Normal samples ``standard_normal * std + mean``."""
    shape = _shape_of(shape)
    dtype = _float_type(dtype)
    key = _next_key()
    tt = dtype.torch_type()

    def make(sl, tdev, slices):
        data = _threefry.normal(key, sl, tt, cuda_random.draw, tdev)
        scale = _local(std, shape, slices, tt, tdev)
        shift = _local(mean, shape, slices, tt, tdev)
        return data * torch.as_tensor(scale, dtype=tt, device=tdev) + torch.as_tensor(
            shift, dtype=tt, device=tdev)

    return _generate(shape, split, device, comm, dtype, make)


def uniform(low=0.0, high=1.0, size=None, dtype=types.float32, split=None, device=None,
            comm=None) -> DNDarray:
    """Uniform samples in [low, high). Array bounds broadcast, as in numpy;
    without ``size`` the shape is the bounds' broadcast shape."""
    if size is None:
        shape = tuple(np.broadcast_shapes(np.shape(low), np.shape(high)))
    else:
        shape = sanitize_shape(size)
    dtype = _float_type(dtype)
    key = _next_key()
    tt = dtype.torch_type()

    def make(sl, tdev, slices):
        lo = _local(low, shape, slices, tt, tdev)
        hi = _local(high, shape, slices, tt, tdev)
        return _threefry.uniform(key, sl, tt, lo, hi, cuda_random.draw, tdev)

    return _generate(shape, split, device, comm, dtype, make)


def rand(*d, dtype: Type[types.datatype] = types.float32, split=None, device=None,
         comm=None) -> DNDarray:
    """Uniform samples in [0, 1) of the shape ``d``."""
    shape = sanitize_shape(d) if d else ()
    dtype = _float_type(dtype)
    key = _next_key()
    tt = dtype.torch_type()
    return _generate(shape, split, device, comm, dtype,
                     lambda sl, tdev, _: _threefry.uniform(key, sl, tt, 0.0, 1.0,
                                                           cuda_random.draw, tdev))


def randint(low, high=None, size=None, dtype=types.int32, split=None, device=None,
            comm=None) -> DNDarray:
    """Random integers in [low, high), or [0, low) without ``high``."""
    if high is None:
        low, high = 0, low
    if low >= high:
        raise ValueError(f"low >= high ({low} >= {high})")
    if size is None:
        size = ()
    elif isinstance(size, builtins.int):
        size = (size,)
    else:
        size = sanitize_shape(size)
    dtype = types.canonical_heat_type(dtype)
    if not issubclass(dtype, types.integer):
        raise ValueError("dtype must be an integer type")
    key = _next_key()
    tt = dtype.torch_type()
    return _generate(tuple(size), split, device, comm, dtype,
                     lambda sl, tdev, _: _threefry.randint(key, sl, low, high, tt,
                                                           cuda_random.draw, tdev))


random_integer = randint


def randn(*d, dtype: Type[types.datatype] = types.float32, split=None, device=None,
          comm=None) -> DNDarray:
    """Standard normal samples of the shape ``d``."""
    return normal(0.0, 1.0, d if d else (), dtype=dtype, split=split, device=device, comm=comm)


def random_sample(shape=None, dtype=types.float32, split=None, device=None,
                  comm=None) -> DNDarray:
    """Uniform samples in [0, 1) with a shape argument."""
    return rand(*_shape_of(shape), dtype=dtype, split=split, device=device, comm=comm)


random = random_sample
ranf = random_sample
sample = random_sample


def randperm(n: int, dtype=types.int64, split=None, device=None, comm=None) -> DNDarray:
    """A random permutation of [0, n), drawn whole on every rank."""
    if not isinstance(n, builtins.int):
        raise TypeError(f"n must be int, got {type(n)}")
    dtype = types.canonical_heat_type(dtype)
    key = _next_key()

    def make(sl, tdev, slices):
        perm = _threefry.permutation(key, n, tdev, cuda_random.draw)
        return perm[slices].to(dtype.torch_type()).contiguous()

    return _generate((n,), split, device, comm, dtype, make)


def permutation(x: Union[int, DNDarray]) -> DNDarray:
    """A random permutation of range(x), or a copy of ``x`` with its rows
    (the first axis) shuffled. A split array keeps its split: each rank
    fetches its rows from their owners in one exchange."""
    if isinstance(x, builtins.int):
        return randperm(x)
    if not isinstance(x, DNDarray):
        raise TypeError(f"x must be int or DNDarray, got {type(x)}")
    perm = _threefry.permutation(_next_key(), x.shape[0], x.larray.device, cuda_random.draw)
    from .indexing import _take_rows

    return _take_rows(x, perm)


def standard_normal(shape=None, dtype=types.float32, split=None, device=None,
                    comm=None) -> DNDarray:
    """Standard normal samples with a shape argument."""
    return normal(0.0, 1.0, _shape_of(shape), dtype=dtype, split=split, device=device,
                  comm=comm)
