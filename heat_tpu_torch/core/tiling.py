"""Tile decompositions (counterpart of ``heat_tpu/core/tiling.py``).

The index calculus of the JAX package, unchanged: tile boundaries from the
ceil chunk rule, tile → rank ownership, start/stop arithmetic.
``tiles[key]`` returns the block of the global array on every rank (a
``torch.Tensor``, through the getitem engine) and ``tiles[key] = v`` writes
it through setitem; each rank touches only the rows of its chunk.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from .dndarray import DNDarray

__all__ = ["SplitTiles", "SquareDiagTiles"]


def _chunk_bounds(n: int, parts: int) -> np.ndarray:
    """Boundaries (len parts+1) of the ceil-rule chunking of ``n`` into
    ``parts`` (the layout rule, ``communication.chunk``)."""
    c = -(-n // parts) if parts else n
    ends = np.minimum(np.arange(1, parts + 1) * c, n)
    return np.concatenate([[0], ends])


class SplitTiles:
    """Chunk-rule tile grid: the array cut into ``comm.size`` blocks along
    every dimension (reference tiling.py:14-330)."""

    def __init__(self, arr: DNDarray):
        if not isinstance(arr, DNDarray):
            raise TypeError(f"arr must be a DNDarray, got {type(arr)}")
        self.__arr = arr
        p = arr.comm.size
        self.__bounds = [_chunk_bounds(s, p) for s in arr.shape]

    @property
    def arr(self) -> DNDarray:
        return self.__arr

    @property
    def lshape_map(self) -> np.ndarray:
        return self.__arr.lshape_map

    @property
    def tile_dimensions(self) -> np.ndarray:
        """(ndim, p) sizes of the tiles in each dimension."""
        return np.stack([np.diff(b) for b in self.__bounds])

    @property
    def tile_ends_g(self) -> np.ndarray:
        """(ndim, p) global end index of each tile per dimension."""
        return np.stack([b[1:] for b in self.__bounds])

    @property
    def tile_locations(self) -> np.ndarray:
        """The rank owning each tile: a (p, …, p) grid following the chunk
        index of the split dimension (-1 everywhere for a replicated
        array)."""
        p = self.__arr.comm.size
        shape = (p,) * self.__arr.ndim
        if self.__arr.split is None:
            return np.full(shape, -1)
        grid = np.zeros(shape, dtype=np.int64)
        view = np.moveaxis(grid, self.__arr.split, -1)
        view[...] = np.arange(p)
        return grid

    def get_tile_size(self, key) -> Tuple[int, ...]:
        """Shape of the tile addressed by ``key``."""
        return tuple(s.stop - s.start for s in self.__key_to_slices(key))

    def __key_to_slices(self, key) -> List[slice]:
        if not isinstance(key, tuple):
            key = (key,)
        if len(key) > self.__arr.ndim:
            raise ValueError(f"key has {len(key)} dims, array has {self.__arr.ndim}")
        key = key + (slice(None),) * (self.__arr.ndim - len(key))
        out = []
        for dim, (k, bounds) in enumerate(zip(key, self.__bounds)):
            p = len(bounds) - 1
            if isinstance(k, int):
                if not -p <= k < p:
                    raise IndexError(f"tile index {k} out of range for dim {dim}")
                k = k % p
                out.append(slice(int(bounds[k]), int(bounds[k + 1])))
            elif isinstance(k, slice):
                start, stop, stride = k.indices(p)
                if stride != 1:
                    raise ValueError("strided tile slices are not supported")
                out.append(slice(int(bounds[start]), int(bounds[stop])))
            else:
                raise TypeError(f"invalid tile key element: {type(k)}")
        return out

    def __getitem__(self, key) -> torch.Tensor:
        return self.__arr[tuple(self.__key_to_slices(key))]._global()

    def __setitem__(self, key, value) -> None:
        self.__arr[tuple(self.__key_to_slices(key))] = value


class SquareDiagTiles:
    """Square tiles along the matrix diagonal (reference tiling.py:331-1245):
    the split dimension cut by the chunk rule, each chunk into
    ``tiles_per_proc`` tiles clamped into the diagonal square, the longer
    axis keeping a final overhang tile."""

    def __init__(self, arr: DNDarray, tiles_per_proc: int = 2):
        if not isinstance(arr, DNDarray):
            raise TypeError(f"arr must be a DNDarray, got {type(arr)}")
        if arr.ndim != 2:
            raise ValueError(f"arr must be 2D, got {arr.ndim}D")
        if tiles_per_proc < 1:
            raise ValueError("tiles_per_proc must be >= 1")
        if arr.split not in (0, 1):
            raise ValueError("SquareDiagTiles requires split 0 or 1")
        self.__arr = arr
        m, n = arr.shape
        p = arr.comm.size
        diag = min(m, n)
        outer = _chunk_bounds(m if arr.split == 0 else n, p)
        inds = [0]
        for r in range(p):
            lo_d, hi_d = min(int(outer[r]), diag), min(int(outer[r + 1]), diag)
            span = hi_d - lo_d
            if span <= 0:
                continue
            sub = _chunk_bounds(span, min(tiles_per_proc, span)) + lo_d
            inds.extend(int(x) for x in sub[1:])
        if inds[-1] < diag:
            inds.append(diag)
        row_bounds, col_bounds = list(inds), list(inds)
        if row_bounds[-1] < m:
            row_bounds.append(m)
        if col_bounds[-1] < n:
            col_bounds.append(n)
        self.__row_bounds = np.asarray(row_bounds)
        self.__col_bounds = np.asarray(col_bounds)
        self.__tiles_per_proc = tiles_per_proc

    @property
    def arr(self) -> DNDarray:
        return self.__arr

    @property
    def lshape_map(self) -> np.ndarray:
        return self.__arr.lshape_map

    @property
    def row_indices(self) -> List[int]:
        """Global start row of each tile row."""
        return [int(x) for x in self.__row_bounds[:-1]]

    @property
    def col_indices(self) -> List[int]:
        """Global start column of each tile column."""
        return [int(x) for x in self.__col_bounds[:-1]]

    @property
    def tile_rows(self) -> int:
        return len(self.__row_bounds) - 1

    @property
    def tile_columns(self) -> int:
        return len(self.__col_bounds) - 1

    def __owner_of(self, start: int) -> int:
        split_len = self.__arr.shape[self.__arr.split]
        p = self.__arr.comm.size
        c = -(-split_len // p)
        return min(start // c, p - 1) if c else 0

    def __per_process(self, axis: int, bounds: np.ndarray, total: int) -> List[int]:
        p = self.__arr.comm.size
        if self.__arr.split != axis:
            return [total] * p
        counts = [0] * p
        for s in bounds[:-1]:
            counts[self.__owner_of(int(s))] += 1
        return counts

    @property
    def tile_rows_per_process(self) -> List[int]:
        """Tiles owned per rank along the rows."""
        return self.__per_process(0, self.__row_bounds, self.tile_rows)

    @property
    def tile_columns_per_process(self) -> List[int]:
        return self.__per_process(1, self.__col_bounds, self.tile_columns)

    @property
    def last_diagonal_process(self) -> int:
        """The rank owning the last diagonal element."""
        return self.__owner_of(min(self.__arr.shape) - 1)

    @property
    def tile_map(self) -> np.ndarray:
        """(tile_rows, tile_columns, 3) of [row_start, col_start, owner]."""
        tm = np.zeros((self.tile_rows, self.tile_columns, 3), dtype=np.int64)
        for i, rs in enumerate(self.row_indices):
            for j, cs in enumerate(self.col_indices):
                tm[i, j] = (rs, cs, self.__owner_of(rs if self.__arr.split == 0 else cs))
        return tm

    def get_start_stop(self, key) -> Tuple[int, int, int, int]:
        """(row_start, row_stop, col_start, col_stop) of a (row, col) tile
        key."""
        i, j = key
        i, j = i % self.tile_rows, j % self.tile_columns
        return (int(self.__row_bounds[i]), int(self.__row_bounds[i + 1]),
                int(self.__col_bounds[j]), int(self.__col_bounds[j + 1]))

    def __getitem__(self, key) -> torch.Tensor:
        r0, r1, c0, c1 = self.get_start_stop(key)
        return self.__arr[r0:r1, c0:c1]._global()

    def __setitem__(self, key, value) -> None:
        r0, r1, c0, c1 = self.get_start_stop(key)
        self.__arr[r0:r1, c0:c1] = value
