"""Printing (counterpart of ``heat_tpu/core/printing.py``): numpy's
formatter with the same threshold, edge-item and precision controls, so
that an array prints the same text as in the JAX package. Printing is a
collective across ranks, as ``numpy()`` is; an array above the threshold
gathers only the edge items numpy's formatter reads."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["get_printoptions", "set_printoptions"]


def get_printoptions() -> dict:
    """The current print options."""
    return dict(np.get_printoptions())


def set_printoptions(precision=None, threshold=None, edgeitems=None, linewidth=None,
                     profile=None, sci_mode=None):
    """Set the print options; the torch-style ``profile`` presets
    ``'default'``, ``'short'`` and ``'full'`` come first, the single options
    after them."""
    if profile == "default":
        np.set_printoptions(precision=4, threshold=1000, edgeitems=3, linewidth=80)
    elif profile == "short":
        np.set_printoptions(precision=2, threshold=1000, edgeitems=2, linewidth=80)
    elif profile == "full":
        np.set_printoptions(precision=4, threshold=np.inf, edgeitems=3, linewidth=80)
    kwargs = {name: value for name, value in (("precision", precision), ("threshold", threshold),
                                              ("edgeitems", edgeitems), ("linewidth", linewidth))
              if value is not None}
    if kwargs:
        np.set_printoptions(**kwargs)


def _edge_items(dndarray) -> np.ndarray:
    """What numpy's formatter reads of an array above the threshold: each
    dimension longer than ``2 * edgeitems`` cut to its first
    ``edgeitems + 1`` and last ``edgeitems`` entries. numpy still summarises
    such a dimension and sizes its columns from the edge items alone, so the
    cut array prints as the whole one. Each rank sends only its own edge
    items."""
    e = np.get_printoptions()["edgeitems"]
    gshape, split, comm = dndarray.shape, dndarray.split, dndarray.comm
    keep = [np.r_[0:e + 1, n - e:n] if n > 2 * e else np.arange(n) for n in gshape]
    if split is not None and comm.size > 1:
        offset, lshape, _ = comm.chunk(gshape, split)
        rows = keep[split]
        keep[split] = rows[(rows >= offset) & (rows < offset + lshape[split])] - offset
    part = dndarray.larray
    for dim, index in enumerate(keep):
        part = part.index_select(dim, torch.as_tensor(index, device=part.device))
    part = part.detach().cpu().numpy()
    if split is None or comm.size == 1:
        return part
    return np.concatenate(comm.allgather_object(part), axis=split)


def __str__(dndarray) -> str:
    """The text of a DNDarray: its values, type, device and split."""
    if dndarray.size > np.get_printoptions()["threshold"]:
        with np.printoptions(threshold=0):  # the cut array summarises as the whole one
            values = np.array2string(_edge_items(dndarray), separator=", ", prefix="DNDarray(")
    else:
        values = np.array2string(dndarray.numpy(), separator=", ", prefix="DNDarray(")
    return (f"DNDarray({values}, dtype=ht.{dndarray.dtype.__name__}, "
            f"device={dndarray.device}, split={dndarray.split})")
