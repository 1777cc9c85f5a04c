"""A frozen reader of flax ``params.msgpack`` files.

flax's ``to_bytes`` writes a msgpack map tree whose array leaves are
msgpack ext type 1, the payload itself msgpack ``[shape, dtype name,
C-order bytes]`` (msgpack spec: github.com/msgpack/msgpack/blob/master/
spec.md). This decodes the types such files hold and nothing else; it is
the benchmark's own, so that the reference reads the weights without the
program's reader.
"""

from __future__ import annotations

import pathlib
import struct

import numpy as np

_NDARRAY = 1

_FIXED = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
          0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
# type byte -> (length format, kind)
_SIZED = {0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
          0xC7: (">B", "ext"), 0xC8: (">H", "ext"), 0xC9: (">I", "ext"),
          0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
          0xDC: (">H", "array"), 0xDD: (">I", "array"),
          0xDE: (">H", "map"), 0xDF: (">I", "map")}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


class _Cursor:
    def __init__(self, data: bytes):
        self.data, self.pos = data, 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack data ends early")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def fmt(self, f: str):
        return struct.unpack(f, self.take(struct.calcsize(f)))[0]


def _compound(cur: _Cursor, kind: str, n: int):
    if kind == "str":
        return cur.take(n).decode("utf-8")
    if kind == "bin":
        return cur.take(n)
    if kind == "array":
        return [_decode(cur) for _ in range(n)]
    if kind == "map":
        out = {}
        for _ in range(n):
            key = _decode(cur)
            out[key] = _decode(cur)
        return out
    code = cur.fmt(">b")
    payload = cur.take(n)
    if code != _NDARRAY:
        raise ValueError(f"msgpack ext type {code} is not an array")
    shape, dtype, buf = decode(payload)
    return np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape)


def _decode(cur: _Cursor):
    t = cur.fmt(">B")
    if t <= 0x7F:
        return t
    if t >= 0xE0:
        return t - 0x100
    if t <= 0x8F:
        return _compound(cur, "map", t & 0x0F)
    if t <= 0x9F:
        return _compound(cur, "array", t & 0x0F)
    if t <= 0xBF:
        return _compound(cur, "str", t & 0x1F)
    if t in (0xC0, 0xC2, 0xC3):
        return {0xC0: None, 0xC2: False, 0xC3: True}[t]
    if t in _FIXED:
        return cur.fmt(_FIXED[t])
    if t in _SIZED:
        f, kind = _SIZED[t]
        return _compound(cur, kind, cur.fmt(f))
    if t in _FIXEXT:
        return _compound(cur, "ext", _FIXEXT[t])
    raise ValueError(f"msgpack type byte 0x{t:02x} is not read here")


def decode(data: bytes):
    """One msgpack object; array leaves as read-only numpy arrays."""
    cur = _Cursor(bytes(data))
    out = _decode(cur)
    if cur.pos != len(cur.data):
        raise ValueError("trailing bytes after the msgpack object")
    return out


def load_params(ckpt_dir) -> dict:
    """``{layer: {"kernel", "bias"}}`` of numpy arrays from
    ``<ckpt_dir>/params.msgpack`` (flax's ``params`` level removed)."""
    tree = decode((pathlib.Path(ckpt_dir) / "params.msgpack").read_bytes())
    return tree.get("params", tree)
