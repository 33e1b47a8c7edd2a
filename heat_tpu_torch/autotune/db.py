"""Persistent tuning database (counterpart of ``heat_tpu/autotune/db.py``):
winners on disk, one JSON record per tuned signature.

Records are written with the atomic-swap discipline of
:mod:`heat_tpu_torch.resilience.checkpoint` (write a temporary file,
``os.replace`` it into place), so a reader never sees a torn record and
concurrent tuners last-write-win a whole record at a time.

The key is a content hash over ``(schema, site, signature, world)``: the
``(site, static-config)`` pair the program registry keys on, with the
process-local communicator replaced by its stable description,
:func:`mesh_fingerprint`: the backend (``cuda`` or ``cpu``), the device
name, the world size and the tiered-topology token. Two processes on the
same world compute the same key, which is what makes the second-process
zero-trial warm start work; a record written on another world or backend
(a CPU record on the card, say) is *foreign* and is rejected at lookup,
the same contract as a checkpoint whose CRC does not match: skip, never
crash, never apply.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
from typing import Any, Dict, Iterator, List, Optional

from .. import _knobs as knobs

__all__ = [
    "SCHEMA",
    "TuneDB",
    "mesh_fingerprint",
    "tune_key",
    "open_db",
]

# Bump on any record-shape change: old records become foreign (rejected
# at lookup), never misread.
SCHEMA = 1

_MESH_FIELDS = ("devices", "backend", "device_kind", "topology")


def mesh_fingerprint() -> Dict[str, Any]:
    """Stable cross-process description of the world a tuning ran on: a
    record applies only to the backend, card, world size and topology it
    was measured on. The backend is the default device's (``cpu`` when
    the CPU is asked for, or when no card is present)."""
    import torch

    from ..core import topology
    from ..core.communication import get_comm
    from ..core.devices import get_device

    cuda = get_device().device_type == "gpu" and torch.cuda.is_available()
    world = int(get_comm().size)
    return {
        "devices": world,
        "backend": "cuda" if cuda else "cpu",
        "device_kind": torch.cuda.get_device_name(torch.cuda.current_device()) if cuda else "cpu",
        "topology": [str(t) for t in topology.cache_token(world)],
    }


def tune_key(
    site: str, signature: Any, mesh: Optional[Dict[str, Any]] = None
) -> str:
    """The database key for one tuned program signature (module
    docstring). ``signature`` is the caller's static config, the role of
    the ``key`` argument of ``program_cache.program_key``, and enters by
    ``repr``, so it must be a stable value (tuples of ints and strings, not
    object identities)."""
    mesh = mesh or mesh_fingerprint()
    payload = repr((
        SCHEMA, str(site), signature,
        int(mesh["devices"]), str(mesh["backend"]),
        str(mesh["device_kind"]), tuple(mesh["topology"]),
    ))
    return hashlib.sha256(payload.encode()).hexdigest()[:32]


def _valid(rec: Any, key: Optional[str], mesh: Dict[str, Any]) -> bool:
    """Schema, key and world validation: the foreign-record gate."""
    if not isinstance(rec, dict):
        return False
    if rec.get("schema") != SCHEMA:
        return False
    if key is not None and rec.get("key") != key:
        return False
    m = rec.get("mesh")
    if not isinstance(m, dict) or any(
        _plain(m.get(f)) != _plain(mesh[f]) for f in _MESH_FIELDS
    ):
        return False
    cfg = rec.get("config")
    if not isinstance(cfg, dict) or not all(
        isinstance(k, str) and k in knobs.REGISTRY and isinstance(v, str)
        for k, v in cfg.items()
    ):
        # a config naming unregistered knobs (or non-string values) can
        # never be installed into the overlay: reject the whole record
        return False
    return True


def _plain(v: Any) -> Any:
    """A fingerprint field as JSON gives it back (tuples become lists)."""
    return list(v) if isinstance(v, tuple) else v


class TuneDB:
    """Directory of atomic-swap JSON tuning records.

    The directory is created lazily on first :meth:`store` — read-only
    consults (``lookup``/``records``/``count``, e.g. ``bench_field`` or
    a disabled tuner with ``HEAT_TPU_TUNE_DB`` merely exported) never
    touch the filesystem beyond reads."""

    def __init__(self, path: str):
        self.path = os.fspath(path)

    def _file(self, key: str) -> str:
        return os.path.join(self.path, f"{key}.json")

    def store(self, record: Dict[str, Any]) -> str:
        """Atomically write one record (validated against the current
        world first: a tuner must never persist a record it would itself
        reject). Returns the record path."""
        key = record.get("key")
        if not key or not _valid(record, key, mesh_fingerprint()):
            raise ValueError(
                "refusing to store an invalid tuning record "
                f"(schema/key/world/config): {record.get('key')!r}"
            )
        os.makedirs(self.path, exist_ok=True)
        final = self._file(key)
        fd, tmp = tempfile.mkstemp(
            prefix=f".{key}.", suffix=".tmp", dir=self.path
        )
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(record, f, sort_keys=True)
                f.write("\n")
            os.replace(tmp, final)  # atomic swap: readers see old or new
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        return final

    def lookup(
        self, key: str, mesh: Optional[Dict[str, Any]] = None
    ) -> Optional[Dict[str, Any]]:
        """The record for ``key``, or None. Corrupt files (torn JSON),
        schema drift, key mismatches, and foreign world or backend records
        all return None: a bad entry degrades to "untuned", never to a
        crash or a wrong config."""
        mesh = mesh or mesh_fingerprint()
        try:
            with open(self._file(key)) as f:
                rec = json.load(f)
        except (OSError, json.JSONDecodeError, UnicodeDecodeError):
            return None
        return rec if _valid(rec, key, mesh) else None

    def records(
        self, mesh: Optional[Dict[str, Any]] = None
    ) -> Iterator[Dict[str, Any]]:
        """Every valid record for this world, oldest store first (so a
        warm start that merges overlapping configs lets the newest tune
        win)."""
        mesh = mesh or mesh_fingerprint()
        rows: List[tuple] = []
        try:
            entries = os.listdir(self.path)
        except OSError:
            return
        for fn in entries:
            if not fn.endswith(".json") or fn.startswith("."):
                continue
            key = fn[: -len(".json")]
            path = os.path.join(self.path, fn)
            try:
                mtime = os.path.getmtime(path)
            except OSError:
                continue
            rec = self.lookup(key, mesh)
            if rec is not None:
                rows.append((mtime, key, rec))
        for _, _, rec in sorted(rows, key=lambda r: (r[0], r[1])):
            yield rec

    def count(self, mesh: Optional[Dict[str, Any]] = None) -> int:
        return sum(1 for _ in self.records(mesh))


def open_db(path: Optional[str] = None) -> Optional[TuneDB]:
    """The active tuning database: explicit ``path``, else
    ``HEAT_TPU_TUNE_DB`` (overlay-aware), else None (tuning runs in memory
    only: winners are adopted for this process but not persisted)."""
    path = path or (knobs.raw("HEAT_TPU_TUNE_DB", "") or "").strip()
    return TuneDB(path) if path else None
