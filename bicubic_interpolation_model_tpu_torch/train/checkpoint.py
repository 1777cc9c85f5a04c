"""Checkpoints: flax msgpack params + the ``meta.json`` sidecar, read and
written byte-compatibly with the JAX package.

The JAX package writes ``params.msgpack`` with
``flax.serialization.to_bytes``: a msgpack map tree whose array leaves are
msgpack ext type 1, the payload itself msgpack ``(shape, dtype_name,
C-order bytes)``. Neither flax nor the ``msgpack`` package is needed here:
:func:`msgpack_unpack` is a small decoder of the msgpack types those files
use, and :func:`msgpack_pack` the encoder that :func:`save` writes with.
"""

from __future__ import annotations

import json
import pathlib
import struct

import numpy as np
import torch

_EXT_NDARRAY = 1        # flax's ndarray ext code


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> bytes:
        end = self.pos + n
        if end > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:end].tobytes()
        self.pos = end
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


def _ext(code: int, payload: bytes):
    if code == _EXT_NDARRAY:
        shape, dtype_name, buf = msgpack_unpack(payload)
        return np.frombuffer(buf, dtype=np.dtype(dtype_name)).reshape(
            shape, order="C")
    raise ValueError(f"unsupported msgpack ext type {code}")


def _value(r: _Reader):
    t = r.unpack("B")
    if t <= 0x7F:
        return t
    if t >= 0xE0:
        return t - 0x100
    if 0x80 <= t <= 0x8F:
        return _map(r, t & 0x0F)
    if 0x90 <= t <= 0x9F:
        return [_value(r) for _ in range(t & 0x0F)]
    if 0xA0 <= t <= 0xBF:
        return r.take(t & 0x1F).decode("utf-8")
    simple = {0xC0: None, 0xC2: False, 0xC3: True}
    if t in simple:
        return simple[t]
    ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
            0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
            0xCA: ">f", 0xCB: ">d"}
    if t in ints:
        return r.unpack(ints[t])
    lengths = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I",      # bin
               0xD9: ">B", 0xDA: ">H", 0xDB: ">I",      # str
               0xDC: ">H", 0xDD: ">I",                  # array
               0xDE: ">H", 0xDF: ">I",                  # map
               0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}      # ext
    if t in lengths:
        n = r.unpack(lengths[t])
        if t <= 0xC6:
            return r.take(n)
        if 0xD9 <= t <= 0xDB:
            return r.take(n).decode("utf-8")
        if t in (0xDC, 0xDD):
            return [_value(r) for _ in range(n)]
        if t in (0xDE, 0xDF):
            return _map(r, n)
        code = r.unpack(">b")
        return _ext(code, r.take(n))
    fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
    if t in fixext:
        code = r.unpack(">b")
        return _ext(code, r.take(fixext[t]))
    raise ValueError(f"unsupported msgpack type byte 0x{t:02x}")


def _map(r: _Reader, n: int) -> dict:
    out = {}
    for _ in range(n):
        k = _value(r)
        out[k] = _value(r)
    return out


def msgpack_unpack(data: bytes):
    """Decode one msgpack object; flax ndarray ext leaves become read-only
    numpy arrays (as ``flax.serialization.msgpack_restore`` returns them)."""
    r = _Reader(data)
    out = _value(r)
    if r.pos != len(r.data):
        raise ValueError(f"{len(r.data) - r.pos} trailing bytes after msgpack "
                         "object")
    return out


def load(ckpt_dir):
    """``(params_tree, meta)`` of a checkpoint directory: the flax state
    dict of numpy arrays and the parsed ``meta.json`` (``{}`` if absent)."""
    d = pathlib.Path(ckpt_dir)
    params = msgpack_unpack((d / "params.msgpack").read_bytes())
    meta = {}
    mp = d / "meta.json"
    if mp.exists():
        meta = json.loads(mp.read_text())
    return params, meta


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------

def _head(out: list, n: int, fix_base: int | None, fix_max: int,
          codes: tuple[int, int, int]) -> None:
    """A length header in msgpack's smallest form: the fix form when
    ``fix_base`` is given and ``n <= fix_max``, else the 8/16/32-bit form
    (``codes``; a 0 entry means the width does not exist for the type)."""
    if fix_base is not None and n <= fix_max:
        out.append(struct.pack(">B", fix_base | n))
        return
    for code, fmt, limit in zip(codes, (">B", ">H", ">I"),
                                (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code and n <= limit:
            out.append(struct.pack(">B", code) + struct.pack(fmt, n))
            return
    raise ValueError(f"msgpack object of {n} entries or bytes is too large")


def _int(out: list, v: int) -> None:
    if 0 <= v <= 0x7F or -32 <= v < 0:
        out.append(struct.pack(">b" if v < 0 else ">B", v))
        return
    forms = ((0xCC, ">B", 0, 0xFF), (0xCD, ">H", 0, 0xFFFF),
             (0xCE, ">I", 0, 0xFFFFFFFF), (0xCF, ">Q", 0, 2 ** 64 - 1)) \
        if v >= 0 else ((0xD0, ">b", -2 ** 7, 0), (0xD1, ">h", -2 ** 15, 0),
                        (0xD2, ">i", -2 ** 31, 0), (0xD3, ">q", -2 ** 63, 0))
    for code, fmt, lo, hi in forms:
        if lo <= v <= hi:
            out.append(struct.pack(">B", code) + struct.pack(fmt, v))
            return
    raise ValueError(f"integer {v} does not fit msgpack")


def _ext_bytes(out: list, code: int, payload: bytes) -> None:
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(payload) in fixext:
        out.append(struct.pack(">B", fixext[len(payload)]))
    else:
        _head(out, len(payload), None, 0, (0xC7, 0xC8, 0xC9))
    out.append(struct.pack(">b", code) + payload)


def _ndarray_payload(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes are not serialisable")
    return msgpack_pack((arr.shape, arr.dtype.name, arr.tobytes("C")))


def _pack(out: list, v) -> None:
    if v is None:
        out.append(b"\xc0")
    elif isinstance(v, bool):
        out.append(b"\xc3" if v else b"\xc2")
    elif isinstance(v, int):
        _int(out, v)
    elif isinstance(v, float):
        out.append(b"\xcb" + struct.pack(">d", v))
    elif isinstance(v, str):
        raw = v.encode("utf-8")
        _head(out, len(raw), 0xA0, 31, (0xD9, 0xDA, 0xDB))
        out.append(raw)
    elif isinstance(v, (bytes, bytearray, memoryview)):
        raw = bytes(v)
        _head(out, len(raw), None, 0, (0xC4, 0xC5, 0xC6))
        out.append(raw)
    elif isinstance(v, (list, tuple)):
        _head(out, len(v), 0x90, 15, (0, 0xDC, 0xDD))
        for item in v:
            _pack(out, item)
    elif isinstance(v, dict):
        _head(out, len(v), 0x80, 15, (0, 0xDE, 0xDF))
        for k, item in v.items():
            _pack(out, k)
            _pack(out, item)
    elif isinstance(v, np.ndarray):
        _ext_bytes(out, _EXT_NDARRAY, _ndarray_payload(v))
    else:
        raise TypeError(f"cannot serialise {type(v).__name__} to msgpack")


def msgpack_pack(obj) -> bytes:
    """Encode ``obj`` as msgpack-python's ``packb`` does (``use_bin_type``,
    the smallest form of every header and integer, floats as float64), with
    numpy arrays as flax's ext type 1. Maps keep their order."""
    out: list = []
    _pack(out, obj)
    return b"".join(out)


def _state_dict(tree):
    """The tree as ``jax.device_get`` hands it to flax in the JAX package's
    ``save``: every map's keys sorted as strings (so ``Conv_10`` precedes
    ``Conv_2``), tensors as numpy arrays of their dtype."""
    if isinstance(tree, dict):
        return {str(k): _state_dict(tree[k])
                for k in sorted(tree, key=str)}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree


def save(ckpt_dir, params, *, meta: dict | None = None) -> pathlib.Path:
    """Write ``params.msgpack`` and ``meta.json`` into ``ckpt_dir`` (made if
    missing), byte-equal to the JAX package's ``train.checkpoint.save`` of
    the same tree: ``params`` is a flax-style tree of tensors (any device)
    or numpy arrays; ``meta.json`` is ``json.dumps(meta, indent=2)``."""
    d = pathlib.Path(ckpt_dir)
    d.mkdir(parents=True, exist_ok=True)
    (d / "params.msgpack").write_bytes(msgpack_pack(_state_dict(params)))
    (d / "meta.json").write_text(json.dumps(meta or {}, indent=2))
    return d
