"""Generic ring pipeline: a stationary block and circulating blocks.

Counterpart of ``heat_tpu/parallel/ring.py``. Each rank keeps its
stationary blocks and passes its circulating blocks one hop a step
(``ring_permute``); step ``t`` sees the blocks that started on rank
``(rank - t * shift) mod p``. The hop loop is ``ring_steps``
(``core/communication.py``), which ring attention, the ring distances and
CholeskyQR2's Gram ring run too. The JAX package's loop makes ``p`` hops,
the last of which returns every block home unread; this one makes the
``p - 1`` that are read.
"""

from __future__ import annotations

from typing import Any, Callable

from ..core.communication import TorchCommunication, ring_steps

__all__ = ["ring_pipeline"]


def ring_pipeline(
    step_fn: Callable,
    stationary: Any,
    circulating: Any,
    init_carry: Any,
    *,
    comm: TorchCommunication,
    shift: int = 1,
) -> Any:
    """Run ``p`` ring steps of ``carry = step_fn(t, origin, stationary,
    circulating, carry)`` on this rank's blocks.

    ``stationary``, ``circulating`` and ``init_carry`` are this rank's
    blocks (tensors, or tuples, lists and dicts of them); every rank's
    circulating blocks have the same shapes. ``origin`` is the rank the
    circulating blocks of step ``t`` started on. Returns this rank's final
    carry."""
    carry = init_carry

    def visit(t, origin, circ):
        nonlocal carry
        carry = step_fn(t, origin, stationary, circ, carry)

    ring_steps(comm, circulating, visit, shift=shift)
    return carry
