"""Per-device memory watermarks.

Counterpart of ``heat_tpu/telemetry/memory.py``, with its names and
fields. Two sources:

* :func:`device_memory_stats`: the caching allocator's statistics of each
  card this process has used (``torch.cuda.memory_stats``), under the JAX
  package's field names: ``bytes_in_use`` is ``allocated_bytes.all.current``
  and ``peak_bytes_in_use`` is ``allocated_bytes.all.peak`` (so it equals
  ``torch.cuda.max_memory_allocated``), beside ``bytes_reserved`` (the
  allocator's pool) and ``bytes_limit`` (the card's memory). ``None`` when
  no card reports, as the JAX package gives on the CPU;
* :func:`live_bytes`: the port's counterpart of ``jax.live_arrays()``,
  which torch does not have: the tensors of the live DNDarrays of this
  process, found by the garbage collector's object list (so nothing is
  registered on the hot path), each storage counted once by its data
  pointer. A replicated array counts once on every rank, since every rank
  holds it. Tensors outside a DNDarray and the allocator's cached blocks
  are not seen, so this is a lower bound of what the device holds: the
  part the arrays of the program hold.
"""

from __future__ import annotations

import gc
from collections import defaultdict
from typing import Dict, Optional

__all__ = ["live_bytes", "device_memory_stats", "watermark"]


def live_bytes() -> dict:
    """``{"total": bytes, "per_device": {device: bytes}, "arrays": count}``
    over the live DNDarrays of this process (module docstring). Views of
    one storage count once, by ``(device, storage data pointer)``; an array
    whose fused chain is still pending counts, with no bytes, and is not
    computed."""
    from ..core.dndarray import DNDarray

    per_device: Dict[str, int] = defaultdict(int)
    count = 0
    seen = set()
    for obj in gc.get_objects():
        if not issubclass(type(obj), DNDarray):  # type(): no proxy's __class__ is read
            continue
        count += 1
        node = obj._fused_node()
        if node is not None and node.buffer is None:
            continue  # a pending chain holds no buffer of its own yet
        t = obj.larray if node is None else node.buffer
        try:
            storage = t.untyped_storage()
            key = (str(t.device), storage.data_ptr())
            if key in seen:
                continue
            seen.add(key)
            per_device[key[0]] += storage.nbytes()
        except RuntimeError:  # a tensor without storage (meta): count its bytes
            per_device[str(t.device)] += t.numel() * t.element_size()
    return {
        "total": sum(per_device.values()),
        "per_device": dict(per_device),
        "arrays": count,
    }


def device_memory_stats() -> Optional[Dict[str, dict]]:
    """The caching allocator's statistics of each card this process has
    allocated on (``bytes_in_use``, ``peak_bytes_in_use``, ``bytes_reserved``,
    ``peak_bytes_reserved``, ``bytes_limit``), keyed ``"cuda:<i>"``; None
    when no card reports (no card, or CUDA not initialised here)."""
    import torch

    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return None
    out: Dict[str, dict] = {}
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        if not stats or "allocated_bytes.all.current" not in stats:
            continue
        out[f"cuda:{i}"] = {
            "bytes_in_use": int(stats["allocated_bytes.all.current"]),
            "peak_bytes_in_use": int(stats["allocated_bytes.all.peak"]),
            "bytes_reserved": int(stats.get("reserved_bytes.all.current", 0)),
            "peak_bytes_reserved": int(stats.get("reserved_bytes.all.peak", 0)),
            "bytes_limit": int(torch.cuda.get_device_properties(i).total_memory),
        }
    return out or None


def watermark(tag: str = "watermark") -> dict:
    """Snapshot memory now, update the registry's high-water marks and,
    when telemetry is enabled, emit a ``memory`` event. Returns the
    snapshot either way (callable as a plain probe)."""
    from . import enabled, get_registry

    snap = live_bytes()
    stats = device_memory_stats()
    if stats is not None:
        snap["device_stats"] = stats
    if enabled():
        reg = get_registry()
        reg.high_water("live_bytes.total", snap["total"])
        for dev, b in snap["per_device"].items():
            reg.high_water(f"live_bytes.{dev}", b)
        if stats is not None:
            for dev, s in stats.items():
                reg.high_water(f"device_bytes.{dev}", s["peak_bytes_in_use"])
        reg.emit("memory", tag, **snap)
    return snap
