"""Tensor-file format (counterpart of
``bicubic_interpolation_model_tpu/data/binfmt.py``): a 12-byte
little-endian header (H, W, C as uint32) followed by float32 data,
byte-compatible with the reference's training data, and ``metadata.json``
beside the sample dirs (sample id → {H_lr, W_lr, H_sr, W_sr,
channels:{X:4, offset:2, Y:16}}) with atomic tmp+rename writes.

The native runtime (``runtime/native``) reads and writes the files when it
is built; the NumPy code below is the fallback and the same bytes.
"""

from __future__ import annotations

import json
import os
import pathlib
import struct

import numpy as np

HEADER = struct.Struct("<III")


def write_tensor(path, arr: np.ndarray) -> None:
    """Write an HWC float32 array with the 12-byte header."""
    arr = np.ascontiguousarray(arr, dtype=np.float32)
    if arr.ndim != 3:
        raise ValueError(f"expected HWC tensor, got shape {arr.shape}")
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    try:
        from ..runtime import native
        if native.available() and native.write_tensor_bin(path, arr):
            return
    except Exception:
        pass
    with open(path, "wb") as f:
        f.write(HEADER.pack(*arr.shape))
        f.write(arr.tobytes())


def read_tensor(path) -> np.ndarray:
    """Read a header-prefixed .bin into an HWC float32 array."""
    try:
        from ..runtime import native
        if native.available():
            out = native.read_tensor_bin(path)
            if out is not None:
                return out
    except Exception:
        pass
    with open(path, "rb") as f:
        h, w, c = HEADER.unpack(f.read(HEADER.size))
        data = np.frombuffer(f.read(h * w * c * 4), dtype="<f4")
    if data.size != h * w * c:
        raise ValueError(f"{path}: truncated tensor ({data.size} != {h}*{w}*{c})")
    return data.reshape(h, w, c).copy()


def update_metadata(metadata_path, sample_id: str, h_lr: int, w_lr: int,
                    h_sr: int, w_sr: int,
                    channels: dict | None = None,
                    variant: str | None = None) -> None:
    """Atomic read-modify-write of metadata.json (tmp file + rename)."""
    metadata_path = pathlib.Path(metadata_path)
    metadata = {}
    if metadata_path.exists():
        metadata = json.loads(metadata_path.read_text())
    entry = {
        "H_lr": int(h_lr), "W_lr": int(w_lr),
        "H_sr": int(h_sr), "W_sr": int(w_sr),
        "channels": channels or {"X": 4, "offset": 2, "Y": 16},
    }
    if variant:
        entry["variant"] = variant
    metadata[sample_id] = entry
    metadata_path.parent.mkdir(parents=True, exist_ok=True)
    tmp = metadata_path.with_suffix(metadata_path.suffix + ".tmp")
    tmp.write_text(json.dumps(metadata, indent=2))
    os.replace(tmp, metadata_path)


def read_metadata(metadata_path) -> dict:
    return json.loads(pathlib.Path(metadata_path).read_text())


def load_dataset_dir(dir_path) -> dict[str, np.ndarray]:
    """Load every .bin in a directory keyed by sample id (file stem) —
    mirrors loadDynamicTensor's map (train.js:20-65)."""
    out = {}
    for p in sorted(pathlib.Path(dir_path).glob("*.bin")):
        out[p.stem.split(".")[0]] = read_tensor(p)
    return out


def load_triplets(root) -> dict[str, dict[str, np.ndarray]]:
    """Load the X/offset/Y training triplets with the id-consistency check
    (train.js:149-152)."""
    root = pathlib.Path(root)
    xs = load_dataset_dir(root / "X")
    offs = load_dataset_dir(root / "offset")
    ys = load_dataset_dir(root / "Y")
    if not (set(xs) == set(offs) == set(ys)):
        raise ValueError("training sample ids do not match across X/offset/Y")
    return {k: {"X": xs[k], "offset": offs[k], "Y": ys[k]} for k in sorted(xs)}
