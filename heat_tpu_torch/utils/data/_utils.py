"""Offline dataset preprocessing (counterpart of
``heat_tpu/utils/data/_utils.py``; reference heat/utils/data/_utils.py:
the ImageNet TFRecord-to-HDF5 merge and the DALI index files of the DASO
ImageNet example).

Host code, run once to produce the HDF5 files that
:class:`~heat_tpu_torch.utils.data.PartialH5Dataset` streams. No
tensorflow and no DALI: the TFRecord framing and the ``tf.train.Example``
protobuf are parsed directly; h5py and PIL are imported when the merge
runs. The same functions as the JAX package's, which is pure Python too.
"""

from __future__ import annotations

import os
import struct

__all__ = ["dali_tfrecord2idx", "merge_files_imagenet_tfrecord"]


def dali_tfrecord2idx(train_dir, train_idx_dir, val_dir, val_idx_dir):
    """Write DALI-style index files (record byte offsets) for every TFRecord
    in ``train_dir``/``val_dir`` (reference _utils.py:13-44). Pure file
    arithmetic — no DALI or tensorflow required: a TFRecord is a sequence of
    ``[u64 length][u32 crc][payload][u32 crc]`` frames."""
    for src_dir, idx_dir in ((train_dir, train_idx_dir), (val_dir, val_idx_dir)):
        os.makedirs(idx_dir, exist_ok=True)
        for name in sorted(os.listdir(src_dir)):
            src = os.path.join(src_dir, name)
            if not os.path.isfile(src):
                continue
            lines = [
                f"{pos} {frame_len}"
                for pos, frame_len, _ in _iter_tfrecord_frames(src, read_payload=False)
            ]
            with open(os.path.join(idx_dir, name + ".idx"), "w") as out:
                out.write("\n".join(lines) + ("\n" if lines else ""))


# -- minimal protobuf wire-format reader (tf.train.Example) -------------------
# The reference parses Examples with tensorflow (reference _utils.py:160-210);
# the wire format is ~40 lines of varint arithmetic, so this offline step
# needs no TF at all. Message layout: Example{1: Features{1: map<string,
# Feature>}}, Feature{1: BytesList, 2: FloatList, 3: Int64List}, each list
# field 1 repeated (floats/ints possibly packed).


def _read_varint(buf, i):
    shift = result = 0
    while True:
        b = buf[i]
        i += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, i
        shift += 7


def _iter_fields(buf):
    """Yield ``(field_number, wire_type, value)`` over one message."""
    i = 0
    n = len(buf)
    while i < n:
        tag, i = _read_varint(buf, i)
        fn, wt = tag >> 3, tag & 7
        if wt == 0:
            v, i = _read_varint(buf, i)
        elif wt == 2:
            ln, i = _read_varint(buf, i)
            v = buf[i : i + ln]
            i += ln
        elif wt == 5:
            v = buf[i : i + 4]
            i += 4
        elif wt == 1:
            v = buf[i : i + 8]
            i += 8
        else:
            raise ValueError(f"unsupported protobuf wire type {wt}")
        yield fn, wt, v


def _parse_example(buf):
    """tf.train.Example bytes → {feature_name: [values...]}."""
    feats = {}
    for fn, _, features in _iter_fields(buf):
        if fn != 1:
            continue
        for fn2, _, entry in _iter_fields(features):
            if fn2 != 1:
                continue
            key, feature = None, b""
            for fn3, _, v3 in _iter_fields(entry):
                if fn3 == 1:
                    key = v3.decode("utf-8")
                elif fn3 == 2:
                    feature = v3
            vals = []
            for fn4, _, lst in _iter_fields(feature):
                for fn5, wt5, v5 in _iter_fields(lst):
                    if fn5 != 1:
                        continue
                    if fn4 == 1:  # BytesList
                        vals.append(v5)
                    elif fn4 == 2:  # FloatList
                        if wt5 == 2:  # packed
                            vals.extend(struct.unpack(f"<{len(v5) // 4}f", v5))
                        else:
                            vals.append(struct.unpack("<f", v5)[0])
                    elif fn4 == 3:  # Int64List
                        if wt5 == 2:  # packed varints
                            j = 0
                            while j < len(v5):
                                x, j = _read_varint(v5, j)
                                vals.append(x)
                        else:
                            vals.append(v5)
            if key is not None:
                feats[key] = vals
    return feats


def _iter_tfrecord_frames(path, read_payload=True):
    """Yield ``(offset, frame_length, payload)`` per TFRecord frame — the
    single frame walker shared by the merge and the DALI indexer.

    ``read_payload=False`` seeks over payload+CRC instead of reading it
    (payload yields as None) — the indexer only needs offsets, so an
    ImageNet-scale shard costs a few KB of header reads, not a full-file
    read. Truncation is still detected (a short frame raises ValueError
    naming the file and offset — tf.data raises DataLossError there); CRC
    words are skipped unverified."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        while True:
            pos = f.tell()
            header = f.read(8)
            if not header:
                return
            if len(header) < 8:
                raise ValueError(f"truncated TFRecord header in {path} at byte {pos}")
            (length,) = struct.unpack("<Q", header)
            if read_payload:
                crc1 = f.read(4)
                payload = f.read(length)
                crc2 = f.read(4)
                if len(crc1) < 4 or len(payload) < length or len(crc2) < 4:
                    raise ValueError(
                        f"truncated TFRecord frame in {path} at byte {pos} "
                        f"(declared {length} payload bytes)"
                    )
            else:
                payload = None
                end = pos + 16 + length
                if end > size:
                    raise ValueError(
                        f"truncated TFRecord frame in {path} at byte {pos} "
                        f"(declared {length} payload bytes)"
                    )
                f.seek(end)
            yield pos, 16 + length, payload


def _iter_tfrecord(path):
    """Yield raw Example payloads of a TFRecord file."""
    for _, _, payload in _iter_tfrecord_frames(path):
        yield payload


def merge_files_imagenet_tfrecord(folder_name, output_folder=None):
    """Merge ImageNet TFRecord shards into the HDF5 files the streaming
    loader consumes (reference _utils.py:47-226; same output schema:
    ``images`` = base64 of the decoded RGB array per image, ``metadata`` =
    (N, 9) float64 ``[height, width, channels, label-1, bbox xmin/xmax/
    ymin/ymax, bbox label]``, ``file_info`` = (N, 4) ``[format, filename,
    synset, text]``) — decode an image via
    ``np.frombuffer(base64.binascii.a2b_base64(s), np.uint8).reshape(h, w, 3)``.

    TF-free re-design: TFRecord framing and the Example protobuf are parsed
    directly (see `_parse_example`), JPEG decoding uses PIL. Shards named
    ``train*`` feed ``imagenet_merged.h5``, ``val*`` feeds
    ``imagenet_merged_validation.h5``.
    """
    import base64

    try:
        import h5py
    except ImportError as e:
        raise ImportError("merge_files_imagenet_tfrecord requires h5py") from e
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            "merge_files_imagenet_tfrecord requires PIL for JPEG decoding"
        ) from e
    import io as _io

    import numpy as np

    output_folder = output_folder if output_folder is not None else folder_name
    names = sorted(os.listdir(folder_name))
    groups = {
        "imagenet_merged.h5": [n for n in names if n.startswith("train")],
        "imagenet_merged_validation.h5": [n for n in names if n.startswith("val")],
    }
    dt = h5py.string_dtype(encoding="ascii")
    flush_every = 256  # bound peak memory: ~0.2 GB of decoded images per block
    for out_name, shards in groups.items():
        if not shards:
            continue
        out_path = os.path.join(output_folder, out_name)
        with h5py.File(out_path, "w") as out:
            out.create_dataset("images", (0,), chunks=True, maxshape=(None,), dtype=dt)
            out.create_dataset("metadata", (0, 9), chunks=True, maxshape=(None, 9))
            out.create_dataset(
                "file_info", (0, 4), chunks=True, maxshape=(None, 4), dtype="S10"
            )
            size = 0
            imgs, metas, infos = [], [], []

            def flush():
                nonlocal size, imgs, metas, infos
                if not imgs:
                    return
                new_size = size + len(imgs)
                out["images"].resize((new_size,))
                out["images"][size:new_size] = imgs
                out["metadata"].resize((new_size, 9))
                out["metadata"][size:new_size] = np.asarray(metas, dtype=np.float64)
                out["file_info"].resize((new_size, 4))
                out["file_info"][size:new_size] = np.asarray(infos, dtype="S10")
                size = new_size
                imgs, metas, infos = [], [], []

            for shard in shards:
                shard_path = os.path.join(folder_name, shard)
                if not os.path.isfile(shard_path):
                    continue
                for payload in _iter_tfrecord(shard_path):
                    feats = _parse_example(payload)
                    raw = feats["image/encoded"][0]
                    arr = np.asarray(
                        Image.open(_io.BytesIO(raw)).convert("RGB"), dtype=np.uint8
                    )
                    imgs.append(base64.binascii.b2a_base64(arr.tobytes()).decode("ascii"))
                    h, w = arr.shape[:2]
                    label = int(feats["image/class/label"][0]) - 1
                    try:
                        bb = [
                            float(feats["image/object/bbox/xmin"][0]),
                            float(feats["image/object/bbox/xmax"][0]),
                            float(feats["image/object/bbox/ymin"][0]),
                            float(feats["image/object/bbox/ymax"][0]),
                            int(feats["image/object/bbox/label"][0]) - 1,
                        ]
                    except (KeyError, IndexError):
                        # reference fallback (its _utils.py:193-198): full-image
                        # box in PIXEL units with label sentinel -2 — consumers
                        # must branch on label == -2 before interpreting units
                        bb = [0.0, float(w), 0.0, float(h), -2]
                    metas.append([float(h), float(w), 3.0, float(label)] + bb)
                    infos.append(
                        [
                            feats.get("image/format", [b""])[0][:10],
                            feats.get("image/filename", [b""])[0][:10],
                            feats.get("image/class/synset", [b""])[0][:10],
                            feats.get("image/class/text", [b""])[0][:10],
                        ]
                    )
                    if len(imgs) >= flush_every:
                        flush()
            flush()
