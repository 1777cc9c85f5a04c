"""Stage table of the learned path on one card: the whole packed forward,
its upstream, the tail alone and kernel G's stage probes.

    python3 scripts/torch_packed_tail_lab.py [--cpu] [--commit REV]

Counterpart of ``scripts/packed_tail_lab.py`` (the TPU lab), on the
committed checkpoint ``model/wp-1e-3-120`` at the 348x510 RGBA frame ->
4x, f32 and bf16 model stages:

- ``full_graph`` / ``full_kernel``: ``models/inference.super_resolve``
  with the graph tail or kernel A (``csrc/packed_tail.cu``), timed by
  ``bench/suite.chained_bench`` and ``bench_program_output``;
- ``upstream``: conv_in, conv_res and the merged map (the graph chain that
  feeds the tail);
- ``tail_graph`` / ``tail_kernel``: the tail alone on that fixed map, as
  its plain graph (``ops/packed_tail.packed_tail_reference``) and as kernel
  G (``csrc/packed_tail_map.cu``);
- kernel G's probes (``bench/labs.g_cases``) on the f32 map and on it
  rounded to bf16: ``matmul`` < ``tanh`` < ``apply`` < the full kernel
  (the TPU lab's ``relayout`` stage is ``tanh`` here: kernel G's apply
  reads the MMA fragments where they lie), each held to its plain version
  first, and the deltas between consecutive stages.

Prints the card's name and power limit beside every number and writes
``build/labs/packed_tail_lab.json``, stamped with the card, torch, the
source revision (``--commit``, else ``git rev-parse HEAD`` where the
checkout has its history) and the date. With ``--cpu`` it checks the
probes' plain versions on a 24x40 crop and measures nothing (stamped
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
from bicubic_interpolation_model_tpu_torch.evaluation import (  # noqa: E402
    model_analysis)
from bicubic_interpolation_model_tpu_torch.models import (  # noqa: E402
    inference as inf)
from bicubic_interpolation_model_tpu_torch.models.layers import (  # noqa: E402
    conv_nhwc)
from bicubic_interpolation_model_tpu_torch.ops import (  # noqa: E402
    packed_tail as pt)

CKPT = ROOT / "model" / "wp-1e-3-120"
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
FRAME = (348, 510)                  # the LR frame of image 0020


def upstream(p, lr_u8, dtype):
    """conv_in, conv_res and the merged packed map [1, h, w, 4, 4, 32] of
    ``lr_u8`` [h, w, c] (the packed forward up to its tail)."""
    lr_f32 = lr_u8[None].float()
    pc, _ = inf._cast_compute(p, lr_f32, dtype)
    xf = (lr_f32 / 255.0).to(dtype)
    with inf._conv_precision(dtype):
        y = torch.relu(conv_nhwc(xf, **pc["conv_in"]))
        y = y + conv_nhwc(y, **pc["conv_res"])
    return inf._packed_merged_map(pc, y, 4, "train")


def main(argv=None) -> int:
    ap = labs.lab_parser(size=False)
    ap.add_argument("--commit", default=None,
                    help="the source revision to stamp (default: git "
                         "rev-parse HEAD where the checkout has history)")
    args = ap.parse_args(argv)
    dev, card = labs.lab_device(args.cpu)
    h, w = (24, 40) if args.cpu else FRAME
    model, params = model_analysis._load_model_any(CKPT, device=dev)
    p = inf._tree(params)
    rng = np.random.default_rng(0)
    lr = torch.from_numpy(labs.u8_frames(rng, h, w, 4)).to(dev)
    timed = not args.cpu
    rows: dict = {}

    def record(name, fn, x, program_output=False):
        if not timed:
            fn(x)                   # the path runs; nothing is measured
        row = {"name": name, "card": card,
               "ms": suite.chained_bench(fn, x) * 1e3 if timed else None}
        if program_output and timed:
            row["program_output_ms"] = suite.bench_program_output(fn, x) * 1e3
        rows[name] = row
        labs.emit(row)

    with torch.no_grad():
        for dname, dt in DTYPES.items():
            for tail in ("graph", "kernel"):
                record(f"full_{tail}_{dname}",
                       lambda x, dt=dt, tail=tail: inf.super_resolve(
                           model, params, x, 4, "train", compute_dtype=dt,
                           tail=tail), lr, program_output=True)
            record(f"upstream_{dname}",
                   lambda x, dt=dt: upstream(p, x, dt), lr)
        m = upstream(p, lr, torch.float32)[0]
        lrf = lr.float()
        kout = p["conv_out"]["kernel"].float()
        bout = p["conv_out"]["bias"].float()
        for dname, mm in (("f32", m), ("bf16", m.to(torch.bfloat16))):
            record(f"tail_graph_{dname}", lambda t: pt.packed_tail_reference(
                t, lrf, kout, bout), mm)
            record(f"tail_kernel_{dname}", lambda t: pt.packed_tail(
                t, lrf, kout, bout, layout="planar"), mm)
        probes = labs.run_cases(labs.g_cases(m, lrf, kout, bout),
                                suite.chained_bench if timed else None,
                                labs.row_emitter(card))
    deltas = None
    if timed:
        deltas = {}
        for dname in DTYPES:
            ms = {r["probe"]: r["ms"] for r in probes.values()
                  if r["name"].endswith(dname)}
            deltas[dname] = labs.stage_deltas(
                ms, ["matmul", "tanh", "apply", "full"])
    table = {"backend": dev.type, "card": card,
             "geometry": f"{h}x{w}x4 -> 4x",
             "checkpoint": CKPT.name, "convention": "train",
             "timing": "bench/suite.chained_bench" if timed else None,
             "rows": rows, "probes": probes, "probe_deltas_ms": deltas,
             "_provenance": configs.provenance(dev, card, args.commit)}
    labs.emit({"probe_deltas_ms": deltas, "card": card})
    labs.write_table("packed_tail_lab", table)
    return 0


if __name__ == "__main__":
    sys.exit(main())
