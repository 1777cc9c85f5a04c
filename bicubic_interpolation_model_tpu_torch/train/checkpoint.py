"""Checkpoint loading: flax msgpack params + the ``meta.json`` sidecar.

The JAX package writes ``params.msgpack`` with
``flax.serialization.to_bytes``: a msgpack map tree whose array leaves are
msgpack ext type 1, the payload itself msgpack ``(shape, dtype_name,
C-order bytes)``. Neither flax nor the ``msgpack`` package is needed here:
:func:`msgpack_unpack` is a small decoder of the msgpack types those files
use. Writing checkpoints waits for the training slice.
"""

from __future__ import annotations

import json
import pathlib
import struct

import numpy as np

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
