"""Kernel D's lab on one card: the phase resize and its probes, timed.

    python3 scripts/torch_kernel_lab.py [--h 1080 --w 1920] [--cpu]

Counterpart of ``scripts/kernel_lab.py`` (the TPU lab). Runs kernel D
(``csrc/resize_phase.cu``) at 4x bicubic on a seeded RGBA frame in its two
layouts and its probe instances (``bench/labs.d_cases``): ``null`` (the
window staged, widened and stored over each LR pixel's 4 x 4 block, no
FMA), ``rowonly`` (the row pass stored at the first column tap, no column
pass), both in both layouts, and ``chw`` (the full resize stored
channel-planar, the TPU lab's ``vP`` with ``to_hwc=False``). Each instance
is held to its plain version first, as ``kernel_lab.main`` holds its
variants to the oracle, then timed by ``bench/suite.chained_bench`` (CUDA
events over a chain of launches on inputs rotated past the L2). Prints ms
per frame and output GPix/s per row with the card's name and power limit,
the stage deltas (column pass, row pass, store), and the TPU lab's variants
``v0``..``vT``, which differ only in how Mosaic is steered and all compute
kernel D's function, as rows that name the kernel D instance timing them.
Writes ``build/labs/kernel_lab.json``. With ``--cpu`` it checks the plain
versions at the given size and measures nothing. Imports nothing of JAX.
"""

from __future__ import annotations

import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from bicubic_interpolation_model_tpu_torch.bench import (  # noqa: E402
    labs, suite)

# the TPU lab's variants of the full phase resize (scripts/kernel_lab.py
# :59-276) and why kernel D times each: on the card one kernel makes the
# choices they compare (the rounding folded into the accumulators' start,
# the column phases stored as interleaved vectors, no epilogue)
L1_VARIANTS = {
    "v0": "per-(p,q) planes and a 16-plane stack, then the XLA interleave",
    "vC": "v0 with the folded rounding chain",
    "vA": "row phases interleaved once on the f32 row pass",
    "vR": "row pass at interleaved rows by a repeat of the window",
    "vS": "strided sublane stores per (p, q)",
    "vR2": "vR with the rounding bias folded into the row pass",
    "vT": "both interleaves in the kernel, HWC out, no epilogue",
}


def main(argv=None) -> int:
    args = labs.lab_parser().parse_args(argv)
    dev, card = labs.lab_device(args.cpu)
    rng = np.random.default_rng(0)
    frame = labs.u8_frames(rng, 1, args.h, args.w, 4)
    frame[..., 3] = 255
    x = torch.from_numpy(frame).to(dev)
    timer = None if args.cpu else suite.chained_bench
    rows = labs.run_cases(labs.d_cases(x), timer,
                          labs.row_emitter(card, args.h * 4 * args.w * 4))
    ms = {k: r["ms"] for k, r in rows.items()}
    deltas = None
    if timer:
        deltas = {
            "column_pass (resize_phase - rowonly)":
                ms["resize_phase"] - ms["resize_phase_probe_rowonly"],
            "row_pass (rowonly - null)":
                ms["resize_phase_probe_rowonly"]
                - ms["resize_phase_probe_null"],
            "floor: stage, widen, store (null)":
                ms["resize_phase_probe_null"],
            "planar: column_pass": ms["resize_phase_planar"]
                - ms["resize_phase_probe_rowonly_planar"],
            "planar: row_pass": ms["resize_phase_probe_rowonly_planar"]
                - ms["resize_phase_probe_null_planar"],
            "chw store - hwc store":
                ms["resize_phase_probe_chw"] - ms["resize_phase"],
        }
    tpu_rows = {v: {"computes": "kernel D's function", "what_it_steers": why,
                    "timed_as": "resize_phase", "ms": ms["resize_phase"]}
                for v, why in L1_VARIANTS.items()}
    table = {"card": card, "geometry": f"{args.h}x{args.w}x4 -> 4x bicubic",
             "timing": None if args.cpu else "bench/suite.chained_bench",
             "rows": rows, "deltas_ms": deltas,
             "tpu_lab_variants": tpu_rows}
    labs.emit({"deltas_ms": deltas, "card": card})
    labs.write_table("kernel_lab", table)
    return 0


if __name__ == "__main__":
    sys.exit(main())
