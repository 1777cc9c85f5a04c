"""Kernels A, G, E, C, D and F of the PyTorch/CUDA port: an earlier
revision against the checkout's, on one card.

    python3 scripts/torch_tail_ab.py PARENT_CSRC

PARENT_CSRC holds an earlier revision's ``packed_tail.cu``,
``packed_tail_map.cu``, ``adaptive.cu``, ``resize_mxu.cu``,
``resize_phase.cu`` and ``resize_banded.cu`` with the headers they include
(``tail_mma.cuh``, ``resize_common.cuh``; for example
from ``git show REV:bicubic_interpolation_model_tpu_torch/csrc/NAME``), with
the same C entry points. The script builds them with nvcc (sm_90a) into a
library of their own in a temporary directory, loads the checkout's kernel
library as the port does, and drives both: A, G and E through the port's
wrappers (``ops/packed_tail.packed_tail_fused``, ``packed_tail``,
``ops/adaptive_fused.adaptive_resize_fused``), C through the wrapper for the
checkout and, for a parent whose ``bim_resize_mxu`` takes the axis plans
themselves (before the bands of ``ops/mxu._bands``), through those plans and
their tile windows; D and F through the wrappers for the checkout and, for a
parent whose ``bim_resize_phase`` takes the plan arrays as they are (before
``ops/phase._kernel_weights``) or whose ``bim_resize_banded`` takes no block
ranges (before ``ops/banded._block_ranges``), through those arrays and that
revision's own 16 x 32 tile bands. First each revision once against the plain
PyTorch
versions, then device times in turns parent / change / change / parent,
with ``chip_smoke.device_ms`` (mean device duration per launch in one
profiler trace of 20 launches, inputs rotated over copies larger than the
L2) at the main paths' shapes: kernel A at 348x510 RGBA with f32 and bf16
features, kernel G on the whole 348x510 frame (f32 and bf16 maps) and on one
band of 4 (87 rows, ``halo="rows"``), kernel E at 1080x1920 RGBA frames of
all three region classes -> 4x in the hwc, planar and opaque-alpha layouts
and on their RGB channels (with whether the two revisions give the same
bytes on two frames: where E's arithmetic did not change they must),
kernel C at 1080x1920 RGBA -> 4x and 2.5x bicubic, kernel D (hwc and
planar) and F at 1080x1920 RGBA -> 4x bicubic. Where a kernel's source
did not change, its two revisions are the same code and their readings show
the spread. Prints one JSON line per check and per reading, the card's name
and power limit, and a summary line last. Imports nothing of JAX.
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

import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402
from bicubic_interpolation_model_tpu_torch.core import (  # noqa: E402
    plan as planlib)
from bicubic_interpolation_model_tpu_torch.ops import (  # noqa: E402
    adaptive_fused as adf, banded, mxu, packed_tail as pt, phase)
from bicubic_interpolation_model_tpu_torch.runtime import build  # noqa: E402

SOURCES = ("packed_tail.cu", "packed_tail_map.cu", "adaptive.cu",
           "resize_mxu.cu", "resize_phase.cu", "resize_banded.cu")
ENTRIES = ("bim_packed_tail_fused", "bim_packed_tail_map",
           "bim_adaptive_resize", "bim_resize_mxu", "bim_resize_phase",
           "bim_resize_banded")
_P, _I = ctypes.c_void_p, ctypes.c_int
# bim_resize_banded of a revision without block ranges
BANDED_NO_RANGES = [_P, _I, _P, _P, _P] + [_I] * 14 + [_P]


def parent_library(csrc: pathlib.Path, out: pathlib.Path,
                   banded_ranges: bool) -> ctypes.CDLL:
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
        fn.argtypes = (BANDED_NO_RANGES if name == "bim_resize_banded"
                       and not banded_ranges else build._SIGNATURES[name])
        fn.restype = ctypes.c_int
    return lib


def plan_windows(idx: np.ndarray, tile: int):
    """Per output tile the least input index its taps read and the largest
    extent over the tiles: the windows of a kernel C that takes the plans
    themselves (the parent's ``ops/mxu._tile_windows``)."""
    n_t = -(-idx.shape[0] // tile)
    pad = n_t * tile - idx.shape[0]
    lo = np.pad(idx.min(axis=1), (0, pad), mode="edge").reshape(n_t, tile)
    hi = np.pad(idx.max(axis=1), (0, pad), mode="edge").reshape(n_t, tile)
    lo, hi = lo.min(axis=1), hi.max(axis=1)
    return lo.astype(np.int32), int((hi - lo).max()) + 1


def plan_resize_mxu(img, iy, wy, ix, wx):
    """Kernel C of a revision whose ``bim_resize_mxu`` takes the axis plans
    (iy, wy, ix, wx) and per-tile windows: u8 [1, h, w, 4] -> u8."""
    b, h, w, c = img.shape
    row_lo, win_r = plan_windows(iy.cpu().numpy(), mxu._TILE_R)
    col_lo, win_c = plan_windows(ix.cpu().numpy(), mxu._TILE_X)
    row_lo, col_lo = (torch.from_numpy(a).to(img.device)
                      for a in (row_lo, col_lo))
    ho, wo = iy.shape[0], ix.shape[0]

    def run(x):
        out = torch.empty((b, ho, wo, c), dtype=torch.uint8, device=x.device)
        rc = build.library().bim_resize_mxu(
            x.data_ptr(), 1, iy.data_ptr(), wy.data_ptr(), ix.data_ptr(),
            wx.data_ptr(), row_lo.data_ptr(), col_lo.data_ptr(),
            out.data_ptr(), b, h, w, c, ho, wo, iy.shape[1], ix.shape[1],
            win_r, win_c, torch.cuda.current_stream().cuda_stream)
        build.check(rc, "resize_mxu (plans)")
        return out
    return run


def plan_resize_phase(img, layout):
    """Kernel D of a revision whose ``bim_resize_phase`` takes the plan
    arrays as they are (wrow [h*4, T], wcol [4*T, w]): u8 [b, h, w, c] ->
    4x bicubic in ``layout``."""
    b, h, w, c = img.shape
    wrow, wcol, taps, left = phase._weights("bicubic", h, w, 4, -0.5, 3,
                                            img.device, None)[:4]
    planar = layout == "planar"
    shape = (b, 4, h * 4, w * c) if planar else (b, h * 4, w * 4, c)

    def run(x):
        out = torch.empty(shape, dtype=torch.uint8, device=x.device)
        rc = build.library().bim_resize_phase(
            x.data_ptr(), 1, wrow.data_ptr(), wcol.data_ptr(),
            out.data_ptr(), b, h, w, c, 4, taps, left, int(planar),
            torch.cuda.current_stream().cuda_stream)
        build.check(rc, "resize_phase (plan arrays)")
        return out
    return run


def ranges_free_resize_banded(img):
    """Kernel F of a revision whose ``bim_resize_banded`` takes no block
    ranges, on its own bands (tiles of 16 x 32 LR pixels, windows of 16 +
    taps rows and 32 + taps columns rounded up to 4): u8 [b, h, w, c] ->
    4x bicubic."""
    b, h, w, c = img.shape
    s, left = 4, 1
    plans = [planlib.plan_axis("bicubic", n, 4.0, a=-0.5) for n in (h, w)]
    k_h = 16 + plans[0].taps
    k_w = -(-(32 + plans[1].taps) // 4) * 4
    b_row = torch.from_numpy(banded._banded(plans[0], 16 * s, k_h, left))
    b_colt = torch.from_numpy(np.ascontiguousarray(banded._banded(
        plans[1], 32 * s, k_w, left).transpose(0, 2, 1)))
    b_row, b_colt = b_row.to(img.device), b_colt.to(img.device)

    def run(x):
        out = torch.empty((b, h * s, w * s, c), dtype=torch.uint8,
                          device=x.device)
        rc = build.library().bim_resize_banded(
            x.data_ptr(), 1, b_row.data_ptr(), b_colt.data_ptr(),
            out.data_ptr(), b, h, w, c, h * s, w * s, b_row.shape[0],
            b_colt.shape[0], 16 * s, 32 * s, k_h, k_w, s, left,
            torch.cuda.current_stream().cuda_stream)
        build.check(rc, "resize_banded (no ranges)")
        return out
    return run


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_tail_ab: no CUDA device visible", file=sys.stderr)
        return 1
    parent_csrc = pathlib.Path(sys.argv[1]).resolve()
    dev = torch.device("cuda")
    name_power = cs.card()
    libs = {"change": build.library()}
    banded_ranges = "krow" in (parent_csrc / "resize_banded.cu").read_text()
    with tempfile.TemporaryDirectory() as tmp:
        libs["parent"] = parent_library(parent_csrc, pathlib.Path(tmp),
                                        banded_ranges)

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
    kernel_of = {name: ("packed_tail_fused_kernel" if name.startswith("a_")
                        else "packed_tail_map_kernel") for name in cases}

    # kernel E: 8 all-class 1080x1920 RGBA frames (66 MB in, 132.7 MB out
    # per call); kernel C: 8 noise frames
    rng = np.random.default_rng(23)
    e_in = [(torch.from_numpy(f[None]).to(dev),)
            for f in cs.all_class_frames(rng, 8, *cs.HD, 4)]
    c_in = [(torch.from_numpy(f[None]).to(dev),)
            for f in cs.u8_frames(rng, 8, *cs.HD, 4)]
    e_rgb = [(x[..., :3].contiguous(),) for (x,) in e_in]
    wts_e = adf._weights(*cs.HD, 4, -0.5, dev, None)
    for layout, opaque, ins in (("hwc", False, e_in), ("planar", False, e_in),
                                ("hwc", True, e_in), ("hwc", False, e_rgb)):
        name = "e_" + ("opaque_alpha" if opaque else layout)
        name += "_rgb" if ins is e_rgb else ""
        cases[name] = (
            lambda x, layout=layout, opaque=opaque: adf.adaptive_resize_fused(
                x, 4, layout=layout, opaque_alpha=opaque),
            lambda x, layout=layout, opaque=opaque:
                adf.adaptive_resize_reference(x, *wts_e, 4, layout=layout,
                                              opaque_alpha=opaque),
            ins, 1)
        kernel_of[name] = "adaptive_kernel"
    c_runs = {}
    for scale in (4, 2.5):
        name = f"c_{scale}x".replace(".", "_")
        ops = mxu._operands("bicubic", *cs.HD, scale, -0.5, 3, dev, None)
        cases[name] = (lambda x, scale=scale: mxu.resize_mxu(x, scale),
                       lambda x, ops=ops: mxu.resize_mxu_reference(
                           x, *ops[:4]), c_in, 1)
        c_runs[name] = plan_resize_mxu(c_in[0][0], *ops[:4])
        kernel_of[name] = "resize_plan_kernel"
    # kernels D and F at 4x bicubic on the same 8 frames
    wrow, wcol, taps, left = phase._weights("bicubic", *cs.HD, 4, -0.5, 3,
                                            dev, None)[:4]
    for layout in ("hwc", "planar"):
        name = "d_" + layout
        cases[name] = (
            lambda x, layout=layout: phase.resize_phase(x, 4, layout=layout),
            lambda x, layout=layout: phase.resize_phase_reference(
                x, wrow, wcol, 4, taps, left, layout=layout), c_in, 1)
        kernel_of[name] = "resize_phase_kernel"
    f_ops = banded._bands("bicubic", *cs.HD, 4, -0.5, 3, dev, None)
    cases["f"] = (lambda x: banded.resize_banded(x, 4),
                  lambda x: banded.resize_banded_reference(
                      x, f_ops[0], f_ops[1], 4, f_ops[2]), c_in, 1)
    kernel_of["f"] = "resize_banded_kernel"
    # the parent's kernel C takes the plans unless its sources take bands;
    # its D the plan arrays unless its sources name the restaged weights;
    # its F no block ranges unless its sources take them
    parent_runs = {}
    if "lo_y" not in (parent_csrc / "resize_mxu.cu").read_text():
        parent_runs.update(c_runs)
    if "_kernel_weights" not in (parent_csrc / "resize_phase.cu").read_text():
        for layout in ("hwc", "planar"):
            parent_runs["d_" + layout] = plan_resize_phase(c_in[0][0],
                                                           layout)
    if not banded_ranges:
        parent_runs["f"] = ranges_free_resize_banded(c_in[0][0])

    def runner(rev, name):
        if rev == "parent" and name in parent_runs:
            return parent_runs[name]
        return cases[name][0]

    outs: dict = {}
    for rev in ("parent", "change"):
        build._lib = libs[rev]
        for name, (_, plain, inputs, tol) in cases.items():
            got = runner(rev, name)(*inputs[0])
            torch.cuda.synchronize()
            mx, share = cs.diff_u8(got.view(torch.uint8),
                                   plain(*inputs[0]).view(torch.uint8))
            cs.emit({"phase": "check", "revision": rev, "case": name,
                     "max": mx, "share": share})
            if mx > tol or (tol == 1 and share >= 1e-3):
                raise AssertionError(f"{rev} {name}: {mx} LSB, share {share}")
            if name.startswith("e_"):
                outs.setdefault(name, []).append(
                    [runner(rev, name)(*x) for x in inputs[:2]])
    for name, (parent_out, change_out) in outs.items():
        same = all(torch.equal(p.view(torch.uint8), c.view(torch.uint8))
                   for p, c in zip(parent_out, change_out))
        cs.emit({"phase": "same_bytes", "case": name, "frames": 2,
                 "equal": same})
    del outs
    ms: dict = {}
    for rev in ("parent", "change", "change", "parent"):
        build._lib = libs[rev]
        for name, (_, _, inputs, _) in cases.items():
            t = cs.device_ms(cs.rotating(runner(rev, name), inputs),
                             kernel=kernel_of[name])
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
