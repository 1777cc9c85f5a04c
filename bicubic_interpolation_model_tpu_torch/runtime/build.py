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
import re
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
_L = ctypes.c_longlong
_F = ctypes.c_float
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
    "bim_conv3x3_tc": [_P, _L, _L, _I, _I, _I, _P, _P, _I, _I, _I,
                       _P, _L, _L, _I, _I, _I, _P, _L, _L, _F,
                       _P, _L, _L, _F, _P],
    "bim_window_attention": [_P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    "bim_linear_tc": [_P, _L, _P, _P, _I, _I, _I, _I, _P, _L, _P, _L, _I, _P],
}
# the probe instances of kernels D, E and G (bench/labs.py): each source's
# second entry point, which launches a production kernel's template with
# one stage cut or replaced
_PROBE_SIGNATURES = {
    "bim_resize_phase_probe": [_P, _P, _P, _P,
                               _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "bim_adaptive_probe": [_P, _P, _P, _P, _P, _P,
                           _I, _I, _I, _I, _I, _I, _I, _P],
    "bim_packed_tail_map_probe": [_P, _I, _P, _P, _P, _P,
                                  _I, _I, _I, _I, _I, _P],
}
# entry points that launch nothing: kernel A's grid as its launch takes it
_QUERY_SIGNATURES = {
    "bim_packed_tail_fused_grid": [_I, _I, _I,
                                   ctypes.POINTER(ctypes.c_longlong),
                                   ctypes.POINTER(ctypes.c_int)],
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
            for name, argtypes in {**_SIGNATURES, **_PROBE_SIGNATURES,
                                   **_QUERY_SIGNATURES}.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check(rc: int, name: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` from a C entry point."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


# one template argument of an Itanium-mangled name: an integer or bool
# literal (``Li4E``, ``Lb0E``, ``Lin1E`` for -1), a length-prefixed type
# name (``13__nv_bfloat16``) or a builtin type's letter
_TEMPLATE_ARG = re.compile(r"L[a-z](n?)(\d+)E|(\d+)|([a-z])")
_TYPE_NAMES = {"__nv_bfloat16": "bf16", "f": "float", "d": "double",
               "i": "int", "j": "unsigned", "b": "bool", "h": "uchar"}


# a length-prefixed source name, at every position (the lengths overlap)
_LENGTH_NAME = re.compile(r"(?=(\d+)[A-Za-z_])")


def _untemplated(mangled: str) -> str:
    """The ``*kernel`` name of a kernel that is no template (``_ZN ...
    23window_attention_kernelE ...``), else ``mangled``."""
    for m in _LENGTH_NAME.finditer(mangled):
        start = m.start() + len(m.group(1))
        name = mangled[start:start + int(m.group(1))]
        if name.endswith("kernel") and len(name) == int(m.group(1)):
            return name
    return mangled


def kernel_instance(mangled: str) -> str:
    """``name<args>`` of a mangled kernel instance, whether its name is
    nested (the anonymous namespace of ``csrc/*.cu``) or not: every
    template argument in order, literals as numbers (bools 0 / 1) and the
    map types as ``float`` / ``bf16``; the plain name of a ``*kernel`` that
    is no template; the mangled name itself where it is neither."""
    m = re.search(r"([A-Za-z_]+kernel)I", mangled)
    if not m:
        return _untemplated(mangled)
    pos, args = m.end(), []
    while pos < len(mangled) and mangled[pos] != "E":
        t = _TEMPLATE_ARG.match(mangled, pos)
        if t is None:
            return mangled
        neg, lit, length, letter = t.groups()
        pos = t.end()
        if lit is not None:
            args.append(("-" if neg else "") + lit)
        elif length is not None:
            name = mangled[pos:pos + int(length)]
            pos += int(length)
            args.append(_TYPE_NAMES.get(name, name))
        else:
            args.append(_TYPE_NAMES.get(letter, letter))
    if pos >= len(mangled):
        return mangled
    return f"{m.group(1)}<{','.join(args)}>"


def ptxas_summary(log: str) -> list[str]:
    """One line per kernel instance of a source's ``ptxas -v`` report: the
    kernel with its template arguments (:func:`kernel_instance`), its
    registers and its spills."""
    lines, name, spill = [], None, ""
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = kernel_instance(ln.split("'")[1])
        elif "spill stores" in ln:
            spill = ln.strip()
        elif "Used" in ln and "registers" in ln:
            lines.append(f"{name}: {ln.split('Used', 1)[1].strip()}; {spill}")
    return lines


def sass_functions(lib_path) -> dict | None:
    """The SASS instruction lines of each kernel instance in a built
    library (cuobjdump of the CUDA toolkit beside nvcc), by
    :func:`kernel_instance`; None without cuobjdump. Two instances that
    read as one name raise."""
    try:
        tool = pathlib.Path(_nvcc()).with_name("cuobjdump")
    except RuntimeError:
        return None
    if not tool.exists():
        return None
    res = subprocess.run([str(tool), "-sass", str(lib_path)],
                         capture_output=True, text=True, timeout=300)
    funcs, fn = {}, None
    for ln in res.stdout.splitlines():
        if "Function :" in ln:
            fn = kernel_instance(ln.split("Function :")[1].strip())
            if fn in funcs:
                raise RuntimeError(f"two kernel instances read as {fn}")
            funcs[fn] = []
        elif fn is not None and re.match(r"\s*/\*[0-9a-f]{4,}\*/", ln):
            funcs[fn].append(ln.strip())
    return funcs


def sass_hmma(lib_path) -> dict | None:
    """Count of HMMA instructions per kernel instance in a built library's
    SASS, for the instances that hold any; None without cuobjdump."""
    funcs = sass_functions(lib_path)
    if funcs is None:
        return None
    counts = {fn: sum("HMMA" in ln for ln in lines)
              for fn, lines in funcs.items()}
    return {fn: n for fn, n in counts.items() if n}
