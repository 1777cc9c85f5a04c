"""Build the hand-written CUDA kernels and bind them with ctypes.

Every ``csrc/*.cu`` exposes a plain C interface (pointers, ints, the CUDA
stream; each entry point returns ``cudaGetLastError()``), so the sources
compile without PyTorch's headers in seconds. The first kernel launch of a
process calls :func:`library`, which compiles each source with its own
``nvcc`` (all started together), links ``build/kernels/libbim_kernels.so``
for ``sm_90a`` and loads it. A library whose recorded source hash matches
is reused. Importing this module builds nothing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "kernels"
LIB_NAME = "libbim_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points and their argument types (see the .cu files)
_SIGNATURES = {
    "bim_packed_tail_fused": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                              _I, _I, _I, _I, _I, _P],
    "bim_packed_tail_map": [_P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "bim_interleave_planar_u32": [_P, _P, _I, _I, _I, _P],
    "bim_resize_mxu": [_P, _I, _P, _P, _P, _P, _P, _P, _P,
                       _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "bim_resize_phase": [_P, _I, _P, _P, _P,
                         _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "bim_adaptive_resize": [_P, _P, _P, _P, _P, _P,
                            _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "bim_resize_banded": [_P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                          _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
}

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([pathlib.Path(home) / "bin" / "nvcc"] if home else []) + [
            pathlib.Path("/usr/local/cuda/bin/nvcc")]:
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA "
                           "kernels are built from csrc/ on first use")
    return found


def sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):      # sources and their headers
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()


def build(force: bool = False) -> dict:
    """Compile and link the kernel library; returns the build record
    (seconds, per-source ptxas report). Reuses an up-to-date library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".sha256")
    digest = _source_hash()
    if (not force and lib_path.exists() and stamp.exists()
            and stamp.read_text() == digest):
        return {"seconds": 0.0, "reused": True, "ptxas": {}}
    nvcc = _nvcc()
    t0 = time.perf_counter()
    objdir = BUILD_DIR / f"obj.{os.getpid()}"
    objdir.mkdir(exist_ok=True)
    procs = []
    for src in sources():
        obj = objdir / (src.stem + ".o")
        procs.append((src, obj, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    ptxas = {}
    failed = []
    for src, _, proc in procs:
        out, _ = proc.communicate()
        ptxas[src.name] = out
        if proc.returncode != 0:
            failed.append(f"{src.name}:\n{out}")
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    tmp = BUILD_DIR / (LIB_NAME + f".{os.getpid()}.tmp")
    link = subprocess.run(
        [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
         *[str(obj) for _, obj, _ in procs]],
        capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    os.replace(tmp, lib_path)
    stamp.write_text(digest)
    shutil.rmtree(objdir, ignore_errors=True)
    return {"seconds": time.perf_counter() - t0, "reused": False,
            "ptxas": ptxas}


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call in this process)."""
    global _lib
    with _lock:
        if _lib is None:
            build()
            lib = ctypes.CDLL(str(BUILD_DIR / LIB_NAME))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check(rc: int, name: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` from a C entry point."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
