"""ctypes binding to the native IO runtime: the repository's
``csrc/bimio.cpp`` (PNG codec, tensor files) and ``csrc/bimjpeg.cpp``
(baseline JPEG), the counterpart of
``bicubic_interpolation_model_tpu/runtime/native.py``.

The first call in a process compiles both sources with ``g++`` into the
port's own git-ignored ``build/native/libbimio.so`` (a library whose
recorded source hash matches is reused; a concurrent build replaces it
atomically). It never runs ``make`` in ``csrc/`` and writes nothing into
the JAX package. Every entry point returns None/False when the library is
unavailable (no compiler, no zlib), so callers fall back to PIL. Set
BIM_TPU_NO_NATIVE=1 to disable it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[2]
SOURCES = [ROOT / "csrc" / "bimio.cpp", ROOT / "csrc" / "bimjpeg.cpp"]
BUILD_DIR = ROOT / "build" / "native"
LIB_PATH = BUILD_DIR / "libbimio.so"
CXXFLAGS = ["-O3", "-fPIC", "-std=c++17", "-shared"]

_lock = threading.Lock()
_lib = None
_build_attempted = False


def _digest() -> str:
    h = hashlib.sha256(" ".join(CXXFLAGS).encode())
    for src in SOURCES:
        h.update(src.read_bytes())
    return h.hexdigest()


def build(force: bool = False) -> pathlib.Path:
    """Compile the library if it is missing or stale; returns its path.
    Raises when the sources or a compiler are missing or the build fails."""
    stamp = BUILD_DIR / "libbimio.so.sha256"
    digest = _digest()
    if (not force and LIB_PATH.exists() and stamp.exists()
            and stamp.read_text() == digest):
        return LIB_PATH
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) found")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"libbimio.so.{os.getpid()}.tmp"
    res = subprocess.run([cxx, *CXXFLAGS, "-o", str(tmp),
                          *map(str, SOURCES), "-lz"],
                         capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed:\n{res.stderr}")
    os.replace(tmp, LIB_PATH)
    stamp.write_text(digest)
    return LIB_PATH


def _load():
    global _lib, _build_attempted
    if _lib is not None or os.environ.get("BIM_TPU_NO_NATIVE"):
        return _lib
    with _lock:
        if _lib is not None or _build_attempted:
            return _lib
        _build_attempted = True
        try:
            lib = ctypes.CDLL(str(build()))
        except (OSError, RuntimeError, subprocess.SubprocessError):
            return None

        u8p = ctypes.POINTER(ctypes.c_uint8)
        f32p = ctypes.POINTER(ctypes.c_float)
        u32 = ctypes.c_uint32
        decode = [ctypes.c_char_p, ctypes.POINTER(u8p),
                  ctypes.POINTER(u32), ctypes.POINTER(u32)]
        sigs = {
            "bim_decode_png_file": decode,
            "bim_decode_jpeg_file": decode,
            "bim_encode_jpeg_file": [ctypes.c_char_p, u8p, u32, u32,
                                     ctypes.c_int, ctypes.c_int],
            "bim_encode_png_file": [ctypes.c_char_p, u8p, u32, u32],
            "bim_read_tensor": [ctypes.c_char_p, ctypes.POINTER(f32p),
                                ctypes.POINTER(u32), ctypes.POINTER(u32),
                                ctypes.POINTER(u32)],
            "bim_write_tensor": [ctypes.c_char_p, f32p, u32, u32, u32],
        }
        for name, argtypes in sigs.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.bim_free.argtypes = [ctypes.c_void_p]
        lib.bim_free.restype = None
        _lib = lib
        return lib


def available() -> bool:
    return _load() is not None


def _decode(fn_name, path) -> np.ndarray | None:
    lib = _load()
    if lib is None:
        return None
    out = ctypes.POINTER(ctypes.c_uint8)()
    w = ctypes.c_uint32()
    h = ctypes.c_uint32()
    rc = getattr(lib, fn_name)(str(path).encode(), ctypes.byref(out),
                               ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        return None
    try:
        n = int(w.value) * int(h.value) * 4
        arr = np.ctypeslib.as_array(out, shape=(n,)).copy()
        return arr.reshape(int(h.value), int(w.value), 4)
    finally:
        lib.bim_free(out)


def decode_png(path) -> np.ndarray | None:
    """PNG file → HWC uint8 RGBA, or None (interlaced files, no library)."""
    return _decode("bim_decode_png_file", path)


def decode_jpeg(path) -> np.ndarray | None:
    """Baseline/extended-sequential Huffman JPEG → HWC uint8 RGBA, or None
    for progressive/arithmetic files (callers fall back to PIL)."""
    return _decode("bim_decode_jpeg_file", path)


def encode_png(path, rgba_u8: np.ndarray) -> bool:
    lib = _load()
    if lib is None:
        return False
    arr = np.ascontiguousarray(rgba_u8, dtype=np.uint8)
    h, w = arr.shape[:2]
    rc = lib.bim_encode_png_file(
        str(path).encode(),
        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_uint32(w), ctypes.c_uint32(h))
    return rc == 0


def encode_jpeg(path, rgba_u8: np.ndarray, quality: int = 92,
                gray: bool = False) -> bool:
    """Baseline 4:4:4 JPEG; ``gray`` emits one component from R."""
    lib = _load()
    if lib is None:
        return False
    arr = np.ascontiguousarray(rgba_u8, dtype=np.uint8)
    h, w = arr.shape[:2]
    rc = lib.bim_encode_jpeg_file(
        str(path).encode(),
        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_uint32(w), ctypes.c_uint32(h),
        ctypes.c_int(int(quality)), ctypes.c_int(1 if gray else 0))
    return rc == 0


def read_tensor_bin(path) -> np.ndarray | None:
    lib = _load()
    if lib is None:
        return None
    data = ctypes.POINTER(ctypes.c_float)()
    h = ctypes.c_uint32()
    w = ctypes.c_uint32()
    c = ctypes.c_uint32()
    rc = lib.bim_read_tensor(str(path).encode(), ctypes.byref(data),
                             ctypes.byref(h), ctypes.byref(w), ctypes.byref(c))
    if rc != 0:
        return None
    try:
        n = int(h.value) * int(w.value) * int(c.value)
        arr = np.ctypeslib.as_array(data, shape=(n,)).copy()
        return arr.reshape(int(h.value), int(w.value), int(c.value))
    finally:
        lib.bim_free(data)


def write_tensor_bin(path, arr: np.ndarray) -> bool:
    lib = _load()
    if lib is None:
        return False
    a = np.ascontiguousarray(arr, dtype=np.float32)
    h, w, c = a.shape
    rc = lib.bim_write_tensor(
        str(path).encode(), a.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_uint32(h), ctypes.c_uint32(w), ctypes.c_uint32(c))
    return rc == 0
