"""Kernel C's lab on one card: the banded resize at rational scales against
the port's float64 oracle, timed beside kernel D.

    python3 scripts/torch_mxu_lab.py --check [--cpu]
    python3 scripts/torch_mxu_lab.py --bench [--h 1080 --w 1920]

Counterpart of ``scripts/mxu_lab.py`` (the TPU lab of the "vM" banded
matmul resize, the prototype of the shipped kernel C). ``--check`` runs the
TPU lab's parity cases (methods, rational scales, odd sizes, 1 and 4
channels) through ``ops/mxu.resize_mxu`` (kernel C on the card, its plain
version with ``--cpu``) and holds each to the port's float64 oracle
(``core/oracle.resize_oracle``, ±1 u8). ``--bench`` runs the TPU lab's
bench scales at 1080x1920 RGBA bicubic through kernel C, each held to the
oracle at every 67th output row (``resize_oracle_rows``), and times it by
``bench/suite.bench_program_output`` (every frame a fresh output, as the TPU
lab times it) and ``chained_bench``; at the integer scales kernel D
(``ops/phase.resize_phase``) is timed beside it the same way. Prints the
card's name and power limit beside every number and writes
``build/labs/mxu_lab.json``. Imports nothing of JAX.
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
from bicubic_interpolation_model_tpu_torch.core import (  # noqa: E402
    oracle)
from bicubic_interpolation_model_tpu_torch.core.plan import (  # noqa: E402
    out_size)
from bicubic_interpolation_model_tpu_torch.ops import (  # noqa: E402
    mxu, phase)

# the TPU lab's check cases (scripts/mxu_lab.py check): method, scale, h,
# w, c
CHECK_CASES = [
    ("bicubic", 4.0, 23, 37, 4), ("bicubic", 4.0, 64, 64, 4),
    ("bicubic", 2.0, 40, 48, 4), ("bilinear", 4.0, 23, 37, 4),
    ("nearest", 4.0, 23, 37, 4), ("lanczos", 4.0, 23, 37, 4),
    ("bicubic", 1.5, 40, 64, 4), ("bicubic", 2.5, 40, 64, 4),
    ("bicubic", 3.0, 23, 37, 4), ("bicubic", 4.0, 23, 37, 1),
    ("lanczos", 1.5, 40, 64, 4),
]
# the TPU lab's bench scales (scripts/mxu_lab.py bench)
BENCH_SCALES = (4.0, 1.5, 2.5, 2.0, 3.0)


def _img(rng, h, w, c):
    im = labs.u8_frames(rng, h, w, c)
    if c == 4:
        im[..., 3] = 255
    return im


def check(dev, card):
    rng = np.random.default_rng(0)
    rows = []
    for method, s, h, w, c in CHECK_CASES:
        img = _img(rng, h, w, c)
        got = mxu.resize_mxu(torch.from_numpy(img).to(dev), s, method)
        want = oracle.resize_oracle(img, s, method)
        d = int(np.abs(got.cpu().numpy().astype(np.int64)
                       - want.astype(np.int64)).max())
        row = {"method": method, "scale": s, "shape": [h, w, c],
               "max_u8_delta": d, "card": card}
        labs.emit(row)
        rows.append(row)
    ok = all(r["max_u8_delta"] <= 1 for r in rows)
    labs.emit({"check": "OK" if ok else "FAIL", "card": card})
    return rows, ok


def bench(dev, card, h, w):
    rng = np.random.default_rng(0)
    img = _img(rng, h, w, 4)
    x = torch.from_numpy(img).to(dev)
    rows = []
    # the plans, built once per geometry: one cache per kernel, since C's
    # and D's keys of one geometry at an integer scale are equal
    c_cache: dict = {}
    d_cache: dict = {}
    for s in BENCH_SCALES:
        impls = {"kernel_c": lambda t, s=s: mxu.resize_mxu(
            t[None], s, layout="flat", weight_cache=c_cache)[0]}
        if s == int(s):
            impls["kernel_d"] = lambda t, s=s: phase.resize_phase(
                t, int(s), weight_cache=d_cache)
        n_rows, n_cols = out_size(h, s), out_size(w, s)
        sample = np.arange(0, n_rows, 67)
        want = oracle.resize_oracle_rows(img, s, sample, "bicubic")
        for name, fn in impls.items():
            got = fn(x).index_select(0, torch.from_numpy(sample).to(dev))
            got = got.cpu().numpy()[:, :n_cols * 4].reshape(
                len(sample), n_cols, 4)
            d = int(np.abs(got.astype(np.int64)
                           - want.astype(np.int64)).max())
            po = suite.bench_program_output(fn, x)
            ch = suite.chained_bench(fn, x)
            row = {"impl": name, "scale": s, "shape": [h, w, 4],
                   "max_u8_delta_every_67th_row": d,
                   "program_output_ms": po * 1e3, "chained_ms": ch * 1e3,
                   "gpix_per_s": n_rows * n_cols / ch / 1e9, "card": card}
            labs.emit(row)
            rows.append(row)
            if d > 1:
                raise AssertionError(f"{name} at {s}x: {d} u8 from the "
                                     "oracle")
    return rows


def main(argv=None) -> int:
    ap = labs.lab_parser()
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--bench", action="store_true")
    args = ap.parse_args(argv)
    dev, card = labs.lab_device(args.cpu)
    table = {"card": card}
    ok = True
    if args.check or not args.bench:
        table["check"], ok = check(dev, card)
    if args.bench:
        if args.cpu:
            raise SystemExit("--bench times the card; it takes no --cpu")
        table["bench"] = bench(dev, card, args.h, args.w)
    labs.write_table("mxu_lab", table)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
