"""Kernel E's ceiling probe on one card: the full kernel against its law
and exemption probes.

    python3 scripts/torch_adaptive_probe_lab.py [--h 1080 --w 1920] [--cpu]
        [--commit REV]

Counterpart of ``scripts/adaptive_probe_lab.py`` (the TPU lab). Runs
kernel E (``csrc/adaptive.cu``) at 4x, planar as the TPU lab times it, on
a seeded 1080x1920 frame of all three region classes (``bench/labs.
all_class_frames``: uniform noise is all edge class, where the texture law
and the exemption never run), at 4 channels and again at 1: the full
instance and the probes ``law_scratch`` (F = 1 from the tap lumas in
shared memory), ``law_const`` (F = 1) and ``fma_only`` (F = 1 and no
exemption), each held to its plain version first (``bench/labs.e_cases``),
then timed by ``bench/suite.chained_bench``. Prints the attribution of the
TPU lab: ``law_alu`` = full - law_scratch, ``luma_reads`` = law_scratch -
law_const (the TPU lab's scratch traffic), ``eq_term`` = law_const -
fma_only, and ``fma_core_plus_epilogue`` = fma_only, with the card's name
and power limit, and writes ``build/labs/adaptive_probe_lab.json``,
stamped with the card, torch, the source revision (``--commit``, else
``git rev-parse HEAD`` where the checkout has its history) and the date.
With ``--cpu`` it checks the plain versions and measures nothing (stamped
backend ``cpu``). Imports nothing of JAX.
"""

from __future__ import annotations

import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from bicubic_interpolation_model_tpu_torch.bench import (  # noqa: E402
    configs, labs, suite)

MODES = ("full", "law_scratch", "law_const", "fma_only")


def attribution(ms: dict) -> dict:
    """The TPU lab's split of the full kernel's time (ms by probe)."""
    return {"law_alu": ms["full"] - ms["law_scratch"],
            "luma_reads": ms["law_scratch"] - ms["law_const"],
            "eq_term": ms["law_const"] - ms["fma_only"],
            "fma_core_plus_epilogue": ms["fma_only"]}


def main(argv=None) -> int:
    ap = labs.lab_parser()
    ap.add_argument("--commit", default=None,
                    help="the source revision to stamp (default: git "
                         "rev-parse HEAD where the checkout has history)")
    args = ap.parse_args(argv)
    dev, card = labs.lab_device(args.cpu)
    frame = labs.all_class_frames(np.random.default_rng(0), 1, args.h,
                                args.w, 4)
    frames = [torch.from_numpy(frame).to(dev),
              torch.from_numpy(frame[..., :1].copy()).to(dev)]
    cases = [c for c in labs.e_cases(frames) if c.probe in MODES]
    timer = None if args.cpu else suite.chained_bench
    rows = labs.run_cases(cases, timer,
                          labs.row_emitter(card, args.h * args.w * 16))
    attr = None
    if timer:
        attr = {}
        for c in (4, 1):
            ms = {r["probe"]: r["ms"] for r in rows.values()
                  if r["name"].endswith("_c1") == (c == 1)}
            attr[f"c{c}"] = attribution(ms)
    labs.emit({"attribution_ms": attr, "card": card})
    table = {"backend": dev.type, "card": card,
             "geometry": f"{args.h}x{args.w} -> 4x planar, "
             "all-class frame, C = 4 and 1",
             "timing": None if args.cpu else "bench/suite.chained_bench",
             "rows": rows, "attribution_ms": attr,
             "_provenance": configs.provenance(dev, card, args.commit)}
    labs.write_table("adaptive_probe_lab", table)
    return 0


if __name__ == "__main__":
    sys.exit(main())
