"""Kernels A and G of the PyTorch/CUDA port: an earlier revision against the
checkout's, on one card.

    python3 scripts/torch_tail_ab.py PARENT_CSRC

PARENT_CSRC holds an earlier revision's ``packed_tail.cu`` and
``packed_tail_map.cu`` (for example from ``git show
REV:bicubic_interpolation_model_tpu_torch/csrc/packed_tail.cu``), with the
same C entry points. The script builds them with nvcc (sm_90a) into a
library of their own in a temporary directory, loads the checkout's kernel
library as the port does, and drives both through the port's wrappers
(``ops/packed_tail.packed_tail_fused`` and ``packed_tail``): first each
revision once against the plain PyTorch versions, then device times in
turns parent / change / change / parent, with ``chip_smoke.device_ms`` (mean
device duration per launch in one profiler trace of 20 launches, inputs
rotated over copies larger than the L2) at the main path's shapes: kernel A
at 348x510 RGBA with f32 and bf16 features, kernel G on the whole 348x510
frame (f32 and bf16 maps) and on one band of 4 (87 rows, ``halo="rows"``).
Prints one JSON line per check and per reading, the card's name and power
limit, and a summary line last. Imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import pathlib
import subprocess
import sys
import tempfile

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from bicubic_interpolation_model_tpu_torch.ops import (  # noqa: E402
    packed_tail as pt)
from bicubic_interpolation_model_tpu_torch.runtime import build  # noqa: E402

SOURCES = ("packed_tail.cu", "packed_tail_map.cu")
ENTRIES = ("bim_packed_tail_fused", "bim_packed_tail_map")


def parent_library(csrc: pathlib.Path, out: pathlib.Path) -> ctypes.CDLL:
    nvcc = build._nvcc()
    objs = []
    for name in SOURCES:
        obj = out / (name + ".o")
        res = subprocess.run([nvcc, *build.NVCC_FLAGS, "-c", str(csrc / name),
                              "-o", str(obj)], capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{res.stdout}"
                               f"{res.stderr}")
        cs.emit({"phase": "parent_build", "source": name, "ptxas": [
            ln.strip() for ln in (res.stdout + res.stderr).splitlines()
            if "registers" in ln or "spill" in ln]})
        objs.append(str(obj))
    lib_path = out / "libparent_tail.so"
    res = subprocess.run([nvcc, *build.NVCC_FLAGS[:2], "-shared", "-o",
                          str(lib_path), *objs], capture_output=True,
                         text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{res.stdout}{res.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    for name in ENTRIES:
        fn = getattr(lib, name)
        fn.argtypes = build._SIGNATURES[name]
        fn.restype = ctypes.c_int
    return lib


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_tail_ab: no CUDA device visible", file=sys.stderr)
        return 1
    parent_csrc = pathlib.Path(sys.argv[1]).resolve()
    dev = torch.device("cuda")
    name_power = cs.card()
    libs = {"change": build.library()}
    with tempfile.TemporaryDirectory() as tmp:
        libs["parent"] = parent_library(parent_csrc, pathlib.Path(tmp))

    h, w = cs.FRAME
    hb = h // 4
    args = cs.tail_case(h, w, 4, dev, seed=7)
    a_in = [(args[0].clone(), args[1].clone()) for _ in range(4)]
    a_bf = [(y.to(torch.bfloat16), lr) for y, lr in a_in]
    g_in = [cs.map_case(h, w, 4, "zero", dev, 70 + k) for k in range(2)]
    kout, bout = g_in[0][2], g_in[0][3]
    g_f32 = [(m, lr) for m, lr, _, _ in g_in]
    g_bf = [(m.to(torch.bfloat16), lr) for m, lr in g_f32]
    gb_in = [cs.map_case(hb, w, 4, "rows", dev, 80 + k)[:2] for k in range(2)]

    def run_a(y, lr):
        return pt.packed_tail_fused(y, lr, *args[2:], layout="planar")

    def plain_a(y, lr):
        return pt.packed_tail_fused_reference(y, lr, *args[2:])

    def run_g(halo):
        return lambda m, lr: pt.packed_tail(m, lr, kout, bout,
                                            layout="planar", halo=halo)

    def plain_g(halo):
        return lambda m, lr: pt.packed_tail_reference(m, lr, kout, bout,
                                                      halo=halo)

    cases = {"a_f32": (run_a, plain_a, a_in, 1),
             "a_bf16": (run_a, plain_a, a_bf, 2),
             "g_frame_f32": (run_g("zero"), plain_g("zero"), g_f32, 1),
             "g_frame_bf16": (run_g("zero"), plain_g("zero"), g_bf, 2),
             "g_band_of_4_f32": (run_g("rows"), plain_g("rows"), gb_in, 1)}
    for rev in ("parent", "change"):
        build._lib = libs[rev]
        for name, (run, plain, inputs, tol) in cases.items():
            got = run(*inputs[0])
            torch.cuda.synchronize()
            mx, share = cs.diff_u8(got.view(torch.uint8),
                                   plain(*inputs[0]).view(torch.uint8))
            cs.emit({"phase": "check", "revision": rev, "case": name,
                     "max": mx, "share": share})
            if mx > tol or (tol == 1 and share >= 1e-3):
                raise AssertionError(f"{rev} {name}: {mx} LSB, share {share}")
    ms: dict = {}
    for rev in ("parent", "change", "change", "parent"):
        build._lib = libs[rev]
        for name, (run, _, inputs, _) in cases.items():
            t = cs.device_ms(cs.rotating(run, inputs), kernel=(
                "packed_tail_fused_kernel" if name.startswith("a_")
                else "packed_tail_map_kernel"))
            ms.setdefault(name, {}).setdefault(rev, []).append(t)
            cs.emit({"phase": "time", "revision": rev, "case": name,
                     "ms": t})
    build._lib = libs["change"]
    print(name_power, flush=True)
    cs.emit({"summary": {name: {
        "parent_ms": r["parent"], "change_ms": r["change"],
        "change_over_parent": (sum(r["change"]) / sum(r["parent"]))}
        for name, r in ms.items()}, "card": name_power})
    return 0


if __name__ == "__main__":
    sys.exit(main())
