"""Kernel E's lab on one card: its launch knobs, its ablations and its
program-output time.

    python3 scripts/torch_adaptive_lab.py {sweep,ablate,progout} [--cpu]
        [--h 1080 --w 1920 --scale 4]

Counterpart of ``scripts/adaptive_lab.py`` (the TPU lab), on a seeded
frame of all three region classes (``bench/labs.all_class_frames``),
RGBA:

- ``sweep``: kernel E (``ops/adaptive_fused.adaptive_resize_fused``) over
  its own launch knobs: the output layout (``planar``, ``hwc``,
  ``hwc32``), opaque alpha, and the phases staged per pass
  (``stage_phases``: 0 is all s x s in one pass; smaller counts take
  several passes, as scales above 14 must);
- ``ablate``: the full kernel and the probes ``nolaw`` (the law replaced
  by one subtract per tap) and ``noeq`` (the exemption dropped), planar,
  each held to its plain version first (``bench/labs.e_cases``);
- ``progout``: ``bench/suite.bench_program_output`` of the planar and hwc
  layouts (every frame a fresh output).

Times by ``bench/suite.chained_bench`` unless said otherwise; prints the
card's name and power limit beside every number and writes
``build/labs/adaptive_lab_<mode>.json``. With ``--cpu`` the modes check
the plain versions and measure nothing. Imports nothing of JAX.
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
from bicubic_interpolation_model_tpu_torch.ops import (  # noqa: E402
    adaptive_fused as adf)

# (layout, opaque alpha, stage_phases)
SWEEP = [("planar", False, 0), ("hwc", False, 0), ("hwc32", False, 0),
         ("hwc", True, 0), ("hwc", False, 8), ("hwc", False, 4),
         ("hwc", False, 1)]


def main(argv=None) -> int:
    ap = labs.lab_parser()
    ap.add_argument("mode", choices=["sweep", "ablate", "progout"])
    ap.add_argument("--scale", type=int, default=4)
    args = ap.parse_args(argv)
    dev, card = labs.lab_device(args.cpu)
    s = args.scale
    frame = labs.all_class_frames(np.random.default_rng(0), 1, args.h,
                                args.w, 4)
    x = torch.from_numpy(frame).to(dev)
    if args.mode == "sweep":
        x[..., 3] = 255             # opaque_alpha promises a constant alpha
    timed = not args.cpu
    cache: dict = {}
    wts = adf._weights(args.h, args.w, s, -0.5, dev, cache)
    rows: list = []
    emit = labs.row_emitter(card, args.h * args.w * s * s, rows)

    if args.mode == "sweep":
        plain = adf.adaptive_resize_reference(x, *wts, s)
        for layout, opaque, stage in SWEEP:
            fn = (lambda t, layout=layout, opaque=opaque, stage=stage:
                  adf.adaptive_resize_fused(
                      t, s, layout=layout, opaque_alpha=opaque,
                      stage_phases=stage, weight_cache=cache))
            got = fn(x)
            if layout == "planar":
                got = adf.unpack_planar(got, args.h, args.w, s, 4)
            ref = (adf.adaptive_resize_reference(x, *wts, s,
                                                 opaque_alpha=True)
                   if opaque else plain)
            err, ok = labs.check_u8(got.contiguous().view(torch.uint8)
                                    .reshape(ref.shape), ref)
            if not ok:
                raise AssertionError(f"{layout} opaque={opaque} stage="
                                     f"{stage}: {err} u8 from the plain "
                                     "version")
            emit({"layout": layout, "opaque_alpha": opaque,
                  "stage_phases": stage, "max_abs_err": err,
                  "ms": suite.chained_bench(fn, x) * 1e3 if timed
                  else None})
    elif args.mode == "ablate":
        frames = [x]
        cases = [c for c in labs.e_cases(frames, cache)
                 if c.probe in ("full", "nolaw", "noeq")]
        res = labs.run_cases(cases, suite.chained_bench if timed else None,
                             emit)
        if timed:
            full = res["adaptive_resize_fused"]["ms"]
            emit({"law_minus_one_subtract_ms":
                  full - res["adaptive_probe_nolaw"]["ms"],
                  "exemption_ms": full - res["adaptive_probe_noeq"]["ms"]})
    else:
        for layout in ("planar", "hwc"):
            fn = (lambda t, layout=layout: adf.adaptive_resize_fused(
                t, s, layout=layout, weight_cache=cache))
            fn(x)
            emit({"layout": layout, "timing": "bench_program_output",
                  "ms": suite.bench_program_output(fn, x) * 1e3 if timed
                  else None})
    table = {"card": card, "mode": args.mode,
             "geometry": f"{args.h}x{args.w}x4 -> {s}x, all-class frame",
             "rows": rows}
    labs.write_table(f"adaptive_lab_{args.mode}", table)
    return 0


if __name__ == "__main__":
    sys.exit(main())
