"""Checkpoint and restore with integrity checks, in the JAX package's format.

Counterpart of ``heat_tpu/resilience/checkpoint.py`` (:78-478 there). A
checkpoint is a directory of ``.npy`` blobs and one JSON manifest,
written as there::

    <path>/
      manifest.json            # written last: its presence commits the dir
      leaf00000_shard000.npy   # one blob per rank of a DNDarray
      leaf00001.npy            # an array: one blob

    {"format": "heat_tpu.checkpoint", "version": 1,
     "leaves": [{"kind": "dndarray", "gshape": [...], "split": 0,
                 "dtype": "float32", "shards": [{"file", "crc32", "shape",
                 "dtype", "index": [[lo, hi], ...]}, ...]},
                {"kind": "array", "file", "crc32", "shape", "dtype"},
                {"kind": "scalar", "value": 3.5, "type": "float"}, ...],
     "extra": {...}}

Because the format is the same, a checkpoint of numpy leaves written by
either package loads in the other: that is how state crosses between them.

- Every blob carries the CRC32 of its file bytes; a flipped byte raises
  :class:`CheckpointCorruptError` naming the file. A missing or truncated
  manifest raises :class:`CheckpointError`.
- The blobs and the manifest go to ``<path>.tmp.<pid>`` and the directory
  is swapped into place after the manifest lands, so a run killed in the
  middle of a save leaves the previous checkpoint whole; stale ``.old.`` and
  ``.tmp.`` siblings are reaped after a commit, and a load falls back to
  the newest committed sibling when ``path`` itself is missing.
- A split DNDarray is written by every rank: its own chunk, with the
  chunk's global index in its shard record (as ``_pack_leaf`` writes a
  sharded jax array there, :133). On restore each rank reads the shards
  that overlap its own chunk of the current world, so the manifest's
  global indices, not the number of ranks that wrote it, decide the
  layout: three ranks' checkpoint restores on one rank and on three. (The
  JAX package's dndarray records hold no index; their shards are the
  chunks in order, which is the same thing.)
- Leaves are DNDarrays, numpy arrays, torch tensors (saved from the host
  copy), Python scalars and None. A pytree is flattened as ``jax.tree``
  flattens it: lists and tuples in order, dicts by sorted key, None an empty
  subtree. An ``array`` leaf restores as a CPU torch tensor.

Across ranks every rank calls :func:`save_checkpoint` with its own part;
rank 0 writes the leaves that are not split, the manifest and the swap. A
failure on any rank raises on every rank.
"""

from __future__ import annotations

import json
import os
import shutil
import zlib
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "CheckpointCorruptError",
    "CheckpointError",
    "exists",
    "load_checkpoint",
    "load_manifest",
    "save_checkpoint",
]

FORMAT = "heat_tpu.checkpoint"
VERSION = 1


class CheckpointError(RuntimeError):
    """A checkpoint could not be written or read (bad manifest, missing
    blobs, structural mismatch)."""


class CheckpointCorruptError(CheckpointError):
    """A blob failed its CRC32 check."""


def _crc32_file(path: str) -> int:
    crc = 0
    with open(path, "rb") as f:
        while True:
            block = f.read(1 << 20)
            if not block:
                break
            crc = zlib.crc32(block, crc)
    return crc


def _write_blob(dirpath: str, name: str, arr: np.ndarray) -> dict:
    fpath = os.path.join(dirpath, name)
    with open(fpath, "wb") as f:
        np.save(f, arr)
    return {"file": name, "crc32": _crc32_file(fpath), "shape": list(arr.shape),
            "dtype": str(arr.dtype)}


def _read_blob(dirpath: str, rec: dict) -> np.ndarray:
    name = rec.get("file")
    fpath = os.path.join(dirpath, name or "")
    if not name or not os.path.exists(fpath):
        raise CheckpointError(f"checkpoint blob {name!r} is missing from {dirpath!r}")
    crc = _crc32_file(fpath)
    if crc != int(rec.get("crc32", -1)):
        raise CheckpointCorruptError(
            f"checkpoint shard {name!r} failed its CRC32 check (stored {rec.get('crc32')}, "
            f"computed {crc}): the blob is corrupt; restore from an older checkpoint")
    try:
        return np.load(fpath, allow_pickle=False)
    except (ValueError, OSError) as e:
        raise CheckpointCorruptError(f"checkpoint shard {name!r} is unreadable ({e})") from None


# -- pytrees: the leaf order of jax.tree.leaves ----------------------------------


def _is_dndarray(x) -> bool:
    from ..core.dndarray import DNDarray

    return isinstance(x, DNDarray)


def _flatten(tree) -> list:
    if tree is None:
        return []
    if isinstance(tree, (list, tuple)) and not _is_dndarray(tree):
        return [leaf for sub in tree for leaf in _flatten(sub)]
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in _flatten(tree[key])]
    return [tree]


def _unflatten(like, leaves: list):
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, (list, tuple)) and not _is_dndarray(node):
            out = [build(sub) for sub in node]
            return type(node)(*out) if hasattr(node, "_fields") else type(node)(out)
        if isinstance(node, dict):
            built = {key: build(node[key]) for key in sorted(node)}
            return type(node)((key, built[key]) for key in node)
        return next(it)

    return build(like)


# -- leaves -----------------------------------------------------------------------


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _pack_leaf(x, dirpath: str, idx: int, rank: int) -> Optional[dict]:
    """This rank's part of one leaf's record: a DNDarray's own shard on
    every rank (with its global index), anything else on rank 0 only
    (None elsewhere)."""
    if _is_dndarray(x):
        split = x.split
        if split is not None or rank == 0:
            offset, lshape, _ = x.comm.chunk(x.shape, split)
            shard_no = rank if split is not None else 0
            rec = _write_blob(dirpath, f"leaf{idx:05d}_shard{shard_no:03d}.npy",
                              np.ascontiguousarray(_host(x.larray)))
            rec["index"] = [[offset, offset + n] if d == split else [0, n]
                            for d, n in enumerate(lshape)]
            shards = [rec]
        else:
            shards = []
        return {"kind": "dndarray", "gshape": list(x.shape), "split": split,
                "dtype": x.dtype.__name__, "shards": shards}
    if isinstance(x, (bool, int, float, str)):
        rec = {"kind": "scalar", "value": x, "type": type(x).__name__}
    elif isinstance(x, complex):
        rec = {"kind": "scalar", "value": [x.real, x.imag], "type": "complex"}
    elif isinstance(x, (np.ndarray, np.generic, torch.Tensor)) or hasattr(x, "__array__"):
        rec = {"kind": "array"}
    else:
        raise CheckpointError(
            f"cannot checkpoint leaf of type {type(x).__name__}: supported leaves are DNDarray, "
            "array-likes, torch tensors, scalars, and None")
    if rank != 0:
        return None
    if rec["kind"] == "array":
        rec.update(_write_blob(dirpath, f"leaf{idx:05d}.npy", _host(x)))
    return rec


def _merge_records(parts: List[list]) -> list:
    """Rank 0's records with every rank's DNDarray shards joined in."""
    records = parts[0]
    for other in parts[1:]:
        for rec, mine in zip(records, other):
            if rec["kind"] == "dndarray" and mine is not None:
                rec["shards"] += [s for s in mine["shards"] if s not in rec["shards"]]
    for rec in records:
        if rec["kind"] == "dndarray":
            rec["shards"].sort(key=lambda s: s["file"])
    return records


def _shard_ranges(rec: dict) -> List[Tuple[dict, List[Tuple[int, int]]]]:
    """Each shard with its global index: from the record, or (the JAX
    package's records) the shards laid end to end along the split axis."""
    gshape = [int(s) for s in rec.get("gshape", [])]
    split = rec.get("split")
    out, start = [], 0
    for s in rec.get("shards", []):
        if "index" in s:
            out.append((s, [(int(a), int(b)) for a, b in s["index"]]))
            continue
        shape = [int(n) for n in s.get("shape", gshape)]
        index = [(0, n) for n in shape]
        if split is not None:
            index[split] = (start, start + shape[split])
            start += shape[split]
        out.append((s, index))
    return out


def _unpack_dndarray(rec: dict, dirpath: str, comm, device):
    from ..core import types
    from ..core.communication import sanitize_comm
    from ..core.devices import sanitize_device
    from ..core.dndarray import DNDarray

    comm = sanitize_comm(comm)
    device = sanitize_device(device)
    split = rec.get("split")
    gshape = tuple(int(s) for s in rec.get("gshape", []))
    shards = _shard_ranges(rec)
    if not shards:
        raise CheckpointError("dndarray record carries no shards")
    dtype = getattr(types, rec.get("dtype", ""), None)
    offset, lshape, _ = comm.chunk(gshape, split)
    lo, hi = (offset, offset + lshape[split]) if split is not None else (0, 0)
    local = None
    for s, index in shards:
        if split is None:
            local = _read_blob(dirpath, s)
            break
        a, b = index[split]
        if b <= lo or a >= hi:
            continue  # another rank's rows
        blob = _read_blob(dirpath, s)
        if local is None:
            local = np.empty(lshape, dtype=blob.dtype)
        dst = [slice(None)] * len(gshape)
        src = [slice(None)] * len(gshape)
        dst[split] = slice(max(a, lo) - lo, min(b, hi) - lo)
        src[split] = slice(max(a, lo) - a, min(b, hi) - a)
        local[tuple(dst)] = blob[tuple(src)]
    if split is not None:
        covered = sum(idx[split][1] - idx[split][0] for _, idx in shards)
        if covered != gshape[split]:
            raise CheckpointError(
                f"the shards cover {covered} of {gshape[split]} rows along axis {split}: "
                "the shard set is incomplete")
        if local is None:  # this rank owns no rows
            blob = _read_blob(dirpath, shards[0][0])
            local = np.empty(lshape, dtype=blob.dtype)
    if tuple(local.shape) != tuple(lshape):
        raise CheckpointError(
            f"reassembled shards give shape {tuple(local.shape)}, expected {tuple(lshape)} "
            f"of {gshape}: the shard set is incomplete")
    t = torch.from_numpy(np.ascontiguousarray(local)).to(device.torch_device)
    if dtype is not None:
        t = t.to(dtype.torch_type())
    else:
        dtype = types.canonical_heat_type(t.dtype)
    return DNDarray(t, gshape, dtype, split, device, comm, True)


def _unpack_leaf(rec: dict, dirpath: str, comm, device):
    kind = rec.get("kind")
    if kind == "dndarray":
        return _unpack_dndarray(rec, dirpath, comm, device)
    if kind == "array":
        return torch.from_numpy(_read_blob(dirpath, rec))
    if kind == "jax_sharded":  # a sharded jax array of the JAX package, reassembled
        shape = tuple(int(s) for s in rec.get("shape", []))
        host = np.empty(shape, dtype=np.dtype(rec.get("dtype", "float64")))
        seen = np.zeros(shape, dtype=bool)
        for s in rec.get("shards", []):
            idx = tuple(slice(int(a), int(b)) for a, b in s.get("index", []))
            host[idx] = _read_blob(dirpath, s)
            seen[idx] = True
        if not seen.all():
            raise CheckpointError(f"jax_sharded record does not cover the full shape {shape}")
        return torch.from_numpy(host)
    if kind == "scalar":
        v = rec.get("value")
        return complex(v[0], v[1]) if rec.get("type") == "complex" else v
    if kind == "none":
        return None
    raise CheckpointError(f"unknown checkpoint leaf kind {kind!r}")


# -- save ---------------------------------------------------------------------


def _world(leaves, comm):
    from ..core.communication import sanitize_comm

    if comm is None:
        comm = next((x.comm for x in leaves if _is_dndarray(x)), None)
    return sanitize_comm(comm)


def _gather(comm, value, err: Optional[BaseException]) -> Tuple[list, list]:
    """Every rank's ``value`` and the errors of the ranks that failed: a
    collective, so that a failure on one rank raises on all of them."""
    parts = comm.allgather_object((value, None if err is None else repr(err)))
    return [v for v, _ in parts], [e for _, e in parts if e is not None]


def save_checkpoint(state, path: str, *, extra: Optional[dict] = None, comm=None) -> str:
    """Checkpoint a pytree of DNDarrays, arrays, tensors and scalars to the
    directory ``path`` (created, or replaced atomically). ``extra`` is a
    JSON-serialisable dict stored in the manifest (iteration counters,
    schedules). Every rank of ``comm`` (the first DNDarray's, else the
    default one) takes part. Returns ``path``."""
    path = os.fspath(path)
    leaves = _flatten(state)
    comm = _world(leaves, comm)
    tmp, err = None, None
    if comm.rank == 0:
        try:
            tmp = f"{path}.tmp.{os.getpid()}"
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
        except Exception as e:  # noqa: BLE001 - raised on every rank below
            err = e
    tmps, errors = _gather(comm, tmp, err)
    if errors:
        raise CheckpointError(f"checkpoint write to {path!r} failed: {errors}") from err
    tmp, records, err = tmps[0], None, None
    try:
        records = [_pack_leaf(x, tmp, i, comm.rank) for i, x in enumerate(leaves)]
    except Exception as e:  # noqa: BLE001
        err = e
    parts, errors = _gather(comm, records, err)
    if not errors and comm.rank == 0:
        try:
            _commit(path, tmp, _merge_records(parts), extra)
        except Exception as e:  # noqa: BLE001
            err = e
    if not errors:
        _, errors = _gather(comm, None, err)
    if errors:
        if comm.rank == 0:
            shutil.rmtree(tmp, ignore_errors=True)
        if isinstance(err, CheckpointError):
            raise err
        raise CheckpointError(f"checkpoint write to {path!r} failed: {errors}") from err
    from .. import telemetry

    if telemetry.enabled():
        reg = telemetry.get_registry()
        reg.add("resilience.checkpoints_saved", 1)
        reg.emit("resilience", path, event="checkpoint_save", leaves=len(leaves))
    return path


def _commit(path: str, tmp: str, records: list, extra: Optional[dict]) -> None:
    """Write the manifest into ``tmp`` and swap it into place."""
    manifest = {"format": FORMAT, "version": VERSION, "leaves": records, "extra": extra or {}}
    mpath = os.path.join(tmp, "manifest.json")
    with open(mpath, "w") as f:
        json.dump(manifest, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    # POSIX has no atomic directory exchange: between the two renames
    # ``path`` is absent, and a load recovers from the sibling that holds
    # the complete checkpoint (the manifest is always written last)
    if os.path.exists(path):
        old = f"{path}.old.{os.getpid()}"
        if os.path.exists(old):
            shutil.rmtree(old)
        os.rename(path, old)
        os.rename(tmp, path)
        shutil.rmtree(old, ignore_errors=True)
    else:
        os.rename(tmp, path)
    _reap_stale_siblings(path)


def _sibling_dirs(path: str) -> List[str]:
    """``<path>.old.<pid>`` and ``<path>.tmp.<pid>`` siblings, newest first."""
    parent = os.path.dirname(os.path.abspath(path)) or "."
    base = os.path.basename(path)
    try:
        names = os.listdir(parent)
    except OSError:
        return []
    out = [os.path.join(parent, n) for n in names
           if (n.startswith(base + ".old.") or n.startswith(base + ".tmp."))
           and os.path.isdir(os.path.join(parent, n))]
    out.sort(key=os.path.getmtime, reverse=True)
    return out


def _reap_stale_siblings(path: str) -> None:
    """Drop the siblings that earlier, crashed saves left behind."""
    for d in _sibling_dirs(path):
        shutil.rmtree(d, ignore_errors=True)


def _resolve_checkpoint_dir(path: str) -> str:
    """``path`` when it holds a manifest, else the newest sibling that does
    (a save killed between its two renames)."""
    if os.path.exists(os.path.join(path, "manifest.json")):
        return path
    for cand in _sibling_dirs(path):
        if os.path.exists(os.path.join(cand, "manifest.json")):
            import warnings

            warnings.warn(f"heat_tpu_torch.resilience: checkpoint {path!r} is missing (save "
                          f"interrupted mid-commit?); recovering from {cand!r}")
            return cand
    return path


# -- load ---------------------------------------------------------------------


def exists(path: str) -> bool:
    """Whether ``path`` holds a loadable checkpoint, a sibling left by a
    save interrupted mid-commit included."""
    path = os.fspath(path)
    return os.path.exists(os.path.join(_resolve_checkpoint_dir(path), "manifest.json"))


def load_manifest(path: str) -> dict:
    """The validated manifest of checkpoint directory ``path``; raises
    :class:`CheckpointError` for a missing, truncated or foreign one."""
    path = os.fspath(path)
    mpath = os.path.join(path, "manifest.json")
    if not os.path.isdir(path) or not os.path.exists(mpath):
        raise CheckpointError(f"{path!r} is not a heat_tpu checkpoint (no manifest.json: an "
                              "interrupted save leaves only a .tmp.* sibling)")
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except (json.JSONDecodeError, OSError, UnicodeDecodeError) as e:
        raise CheckpointError(f"checkpoint manifest {mpath!r} is truncated or corrupt ({e})") \
            from None
    if not isinstance(manifest, dict) or manifest.get("format") != FORMAT:
        got = manifest.get("format") if isinstance(manifest, dict) else "?"
        raise CheckpointError(f"checkpoint manifest {mpath!r} has format {got!r}, "
                              f"expected {FORMAT!r}")
    if int(manifest.get("version", -1)) > VERSION:
        raise CheckpointError(f"checkpoint {path!r} was written by a newer format version "
                              f"({manifest.get('version')} > {VERSION})")
    return manifest


def load_checkpoint(path: str, like=None, comm=None, device=None, *, with_extra: bool = False):
    """Restore a checkpoint written by :func:`save_checkpoint` (of either
    package). ``like`` gives the pytree to rebuild, else a flat leaf list
    is returned. DNDarray leaves land on ``comm`` and ``device`` (the
    defaults when None), each rank reading the shards of its own chunk.
    Every blob read is CRC-checked. ``with_extra=True`` returns
    ``(tree, extra)``."""
    path = _resolve_checkpoint_dir(os.fspath(path))
    manifest = load_manifest(path)
    leaves: List[Any] = [_unpack_leaf(rec, path, comm, device)
                         for rec in manifest.get("leaves", [])]
    tree = leaves
    if like is not None:
        want = len(_flatten(like))
        if want != len(leaves):
            raise CheckpointError(f"checkpoint {path!r} holds {len(leaves)} leaves but the "
                                  f"'like' structure expects {want}")
        tree = _unflatten(like, leaves)
    if with_extra:
        return tree, manifest.get("extra", {})
    return tree
