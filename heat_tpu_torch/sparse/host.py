"""Host-side CSR row batches (the port's own copy of
``heat_tpu/sparse/host.py``).

:class:`CsrRows` is a numpy-only container for a batch of sparse feature
rows in CSR form, the shape a sparse request has before it reaches a
device. It imports nothing but numpy, so a serving layer can use it without
the array machinery.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

__all__ = ["CsrRows"]


class CsrRows:
    """A batch of sparse rows over ``cols`` features, CSR layout.

    ``indptr`` is ``(rows + 1,)`` int64 monotone with ``indptr[0] == 0``;
    ``indices`` (column ids, int32, each ``< cols``) and ``values``
    (float) are ``(nnz,)``. Rows may be empty; duplicate columns within a
    row are rejected only where a consumer requires it (the serving
    kernel sums duplicates, matching scipy's unconsolidated semantics).
    """

    __slots__ = ("indptr", "indices", "values", "cols")

    def __init__(self, indptr, indices, values, cols: int):
        indptr = np.asarray(indptr, dtype=np.int64).reshape(-1)
        indices = np.asarray(indices, dtype=np.int32).reshape(-1)
        values = np.asarray(values).reshape(-1)
        cols = int(cols)
        if cols <= 0:
            raise ValueError(f"cols must be positive, got {cols}")
        if indptr.size < 1 or indptr[0] != 0:
            raise ValueError("indptr must start at 0")
        if (np.diff(indptr) < 0).any():
            raise ValueError("indptr must be monotone non-decreasing")
        if int(indptr[-1]) > indices.size or indices.size != values.size:
            # indices/values may extend PAST indptr[-1]: those slots are
            # nnz-bucket pad (column 0, value 0) no row ever reaches —
            # the padded() lattice form the serving batcher dispatches
            raise ValueError(
                f"indptr accounts for {int(indptr[-1])} entries but "
                f"indices/values hold {indices.size}/{values.size}"
            )
        if indices.size and (
            (indices < 0).any() or (indices >= cols).any()
        ):
            raise ValueError(f"column indices must lie in [0, {cols})")
        self.indptr = indptr
        self.indices = indices
        self.values = values
        self.cols = cols

    # -- shape arithmetic -----------------------------------------------------

    @property
    def rows(self) -> int:
        return self.indptr.size - 1

    @property
    def nnz(self) -> int:
        return int(self.indptr[-1])

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.rows, self.cols)

    def __len__(self) -> int:
        return self.rows

    def __repr__(self) -> str:
        return (
            f"CsrRows(rows={self.rows}, cols={self.cols}, nnz={self.nnz}, "
            f"dtype={self.values.dtype})"
        )

    # -- construction ---------------------------------------------------------

    @classmethod
    def from_dense(cls, arr) -> "CsrRows":
        """Compact the nonzeros of a dense ``(rows, cols)`` (or 1-D) array."""
        a = np.asarray(arr)
        if a.ndim == 1:
            a = a[None, :]
        if a.ndim != 2:
            raise ValueError(f"expected 1-D or 2-D input, got {a.ndim}-D")
        rows, cols = np.nonzero(a)
        indptr = np.zeros(a.shape[0] + 1, dtype=np.int64)
        np.add.at(indptr, rows + 1, 1)
        return cls(
            np.cumsum(indptr), cols.astype(np.int32), a[rows, cols],
            a.shape[1],
        )

    def to_dense(self) -> np.ndarray:
        """Densify (duplicate columns within a row sum, scipy-style).
        Pad element slots past ``indptr[-1]`` are ignored."""
        out = np.zeros((self.rows, self.cols), dtype=self.values.dtype)
        row_of = np.repeat(np.arange(self.rows), np.diff(self.indptr))
        nnz = self.nnz
        np.add.at(out, (row_of, self.indices[:nnz]), self.values[:nnz])
        return out

    # -- batching (the micro-batcher's operations) ----------------------------

    def __getitem__(self, key) -> "CsrRows":
        """Row slicing (contiguous slices only — what the batcher's
        oversize chunking needs)."""
        if not isinstance(key, slice) or key.step not in (None, 1):
            raise TypeError("CsrRows supports contiguous row slices only")
        start, stop, _ = key.indices(self.rows)
        stop = max(stop, start)
        lo, hi = int(self.indptr[start]), int(self.indptr[stop])
        return CsrRows(
            self.indptr[start:stop + 1] - lo,
            self.indices[lo:hi],
            self.values[lo:hi],
            self.cols,
        )

    @staticmethod
    def concat(parts: Sequence["CsrRows"]) -> "CsrRows":
        """Stack row batches (all over the same ``cols``) — the
        micro-batch coalescing step. Pad element slots past a part's
        ``indptr[-1]`` (the legal padded lattice form a client may send
        over the wire) are STRIPPED: concatenating them whole would
        shift every later part's row pointers into the pad region."""
        parts = list(parts)
        if not parts:
            raise ValueError("concat needs at least one CsrRows")
        cols = parts[0].cols
        if any(p.cols != cols for p in parts):
            raise ValueError("cannot concat CsrRows over different cols")
        if len(parts) == 1:
            return parts[0]
        ips: List[np.ndarray] = [parts[0].indptr]
        off = parts[0].nnz
        for p in parts[1:]:
            ips.append(p.indptr[1:] + off)
            off += p.nnz
        return CsrRows(
            np.concatenate(ips),
            np.concatenate([p.indices[:p.nnz] for p in parts]),
            np.concatenate([p.values[:p.nnz] for p in parts]),
            cols,
        )

    def padded(self, rows: int, nnz: int) -> "CsrRows":
        """Pad to exactly ``(rows, nnz)``: appended rows are empty,
        appended element slots carry ``(column 0, value 0)`` and belong
        to no row (``indptr`` never reaches them) — the masked-neutral
        pad discipline of the serving batcher (pad slots cannot perturb
        a real row's reduction)."""
        if rows < self.rows or nnz < self.nnz:
            raise ValueError(
                f"cannot pad {self.shape}/{self.nnz}nnz down to "
                f"({rows}, ...)/{nnz}nnz"
            )
        ip = np.concatenate([
            self.indptr,
            np.full(rows - self.rows, self.nnz, dtype=np.int64),
        ])
        ix = np.concatenate([
            self.indices, np.zeros(nnz - self.nnz, dtype=np.int32),
        ])
        v = np.concatenate([
            self.values,
            np.zeros(nnz - self.nnz, dtype=self.values.dtype),
        ])
        return CsrRows(ip, ix, v, self.cols)
