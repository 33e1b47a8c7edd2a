"""Halo exchange: the neighbours' edge rows, for stencils and boundaries.

Counterpart of ``heat_tpu/parallel/halo.py`` (``halo_exchange``,
``halo_stencil``) and the single home of the halo hops, which
``DNDarray.get_halo`` uses too: every rank sends its last ``halo_size``
rows along the split axis to the next rank and its first to the previous
one (one ``ppermute`` each way). The terminal ranks get zeros, or with
``wrap=True`` the other end's rows (a periodic boundary).

The functions take this rank's block: a DNDarray (split along ``axis``; its
chunks may be uneven, as the ceil rule makes them) or this rank's tensor
with ``comm``. They return this rank's block grown by the halos, a tensor.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple, Union

import torch

from ..core.communication import TorchCommunication, sanitize_comm

__all__ = ["halo_exchange", "halo_stencil"]


def _halo_parts(local: torch.Tensor, halo_size: int, axis: int, comm: TorchCommunication,
                wrap: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(from_prev, from_next)``: the previous rank's last ``halo_size``
    rows and the next rank's first, zeros past the terminal ranks unless
    ``wrap``."""
    p = comm.size
    n = local.shape[axis]
    lead = local.narrow(axis, 0, halo_size).contiguous()
    trail = local.narrow(axis, n - halo_size, halo_size).contiguous()
    # a pair left out of the permutation delivers zeros: the open boundary
    fwd = [(i, (i + 1) % p) for i in range(p if wrap else p - 1)]
    bwd = [((i + 1) % p, i) for i in range(p if wrap else p - 1)]
    return comm.ppermute(trail, fwd), comm.ppermute(lead, bwd)


def _local_block(x, comm: Optional[TorchCommunication], axis: int, halo_size: int):
    """This rank's block and communicator, after the JAX package's check
    that no block is shorter than the halo (on every rank: a rank that
    raised alone would leave the others waiting in the hop)."""
    from ..core.dndarray import DNDarray

    if not isinstance(halo_size, int) or halo_size <= 0:
        raise ValueError(f"halo_size needs to be a positive integer, got {halo_size}")
    if isinstance(x, DNDarray):
        if x.split != axis:
            raise ValueError(f"halo along axis {axis} of an array split along {x.split}")
        comm = x.comm
        smallest = int(x.lshape_map[:, axis].min())
        local = x.larray
    else:
        comm = sanitize_comm(comm)
        local = x
        smallest = min(comm.allgather_object(int(local.shape[axis])))
    if smallest < halo_size:
        raise ValueError(f"halo_size {halo_size} exceeds local extent {smallest}")
    return local, comm


def halo_exchange(
    x,
    halo_size: int,
    *,
    comm: Optional[TorchCommunication] = None,
    axis: int = 0,
    wrap: bool = False,
    return_parts: bool = False,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """This rank's block along ``axis`` with ``halo_size`` rows of the
    previous rank prepended and ``halo_size`` of the next appended (zeros
    at the terminal ranks unless ``wrap``). ``return_parts=True`` returns
    ``(from_prev, from_next)`` instead, the form ``DNDarray.get_halo``
    keeps."""
    local, comm = _local_block(x, comm, axis, halo_size)
    from_prev, from_next = _halo_parts(local, halo_size, axis, comm, wrap)
    if return_parts:
        return from_prev, from_next
    return torch.cat([from_prev, local, from_next], dim=axis)


def halo_stencil(
    x,
    halo_size: int,
    fn: Callable[[torch.Tensor], torch.Tensor],
    *,
    comm: Optional[TorchCommunication] = None,
    axis: int = 0,
    wrap: bool = False,
    sides: str = "both",
) -> torch.Tensor:
    """``fn`` of this rank's block extended by the halos of ``sides``
    (``"prev"``, ``"next"`` or ``"both"``): a stencil that needs its
    neighbours' rows, as local compute and two hops."""
    if sides not in ("prev", "next", "both"):
        raise ValueError(f"sides must be 'prev', 'next' or 'both', got {sides!r}")
    local, comm = _local_block(x, comm, axis, halo_size)
    from_prev, from_next = _halo_parts(local, halo_size, axis, comm, wrap)
    parts = ([from_prev] if sides in ("prev", "both") else []) + [local]
    parts += [from_next] if sides in ("next", "both") else []
    return fn(torch.cat(parts, dim=axis))
