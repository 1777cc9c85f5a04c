"""Per-method throughput on one card.

    python3 scripts/torch_method_throughput.py [--only SECTIONS] [--cpu]
        [--commit REV]

Counterpart of ``scripts/method_throughput.py`` (the TPU script), with its
sections and ``--only`` flag (``classical,adaptive,learned,neural,
rational,train,downsample``; default all) and its geometries: classical
methods at 1080p -> 4x (kernels C and D), adaptive (kernel E) and every
committed learned (kernel A) and direct model at the reference's 0020
geometry (LR 348x510 -> 4x) beside the reference's ms, rational 1.5x and
2.5x at 1080p (kernel C against the plain graphs), downsample at the 0020
HR geometry and 4K -> /4, and weight-predictor training steps. Rows come
from ``bench/methods.run``, stamped with the card's name and power limit;
times are the suite's CUDA-event slopes. Writes
``build/results/method_throughput.json``, keeping the rows of sections not
run, stamped with the card, torch, the source revision (``--commit``, else
``git rev-parse HEAD`` where the checkout has its history) and the date
of this run. Exits 1 when a row's output of the frame it times reads more
than 1 u8 from its oracle or (on the card) a row's launches differ from
its expected ones. With ``--cpu`` it runs the sections once at a small size and measures
nothing (stamped backend ``cpu``). Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from bicubic_interpolation_model_tpu_torch.bench import (  # noqa: E402
    configs, labs, methods)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default="",
                    help="comma list of sections to measure ("
                         + ",".join(methods.SECTIONS) + "); default all. "
                         "Other sections keep their previous JSON rows.")
    ap.add_argument("--cpu", action="store_true",
                    help="run the sections once at a small size; time "
                         "nothing")
    ap.add_argument("--commit", default=None,
                    help="the source revision to stamp (default: git "
                         "rev-parse HEAD where the checkout has history)")
    args = ap.parse_args(argv)
    sections = set(filter(None, args.only.split(","))) or set(
        methods.SECTIONS)
    dev, card = configs.device_and_card(args.cpu)
    fresh = methods.run(
        sections, geo=methods.SMALL if args.cpu else methods.FULL, dev=dev,
        card=card, emit=lambda name, row: labs.emit({"row": name, **row}))
    path = configs.RESULTS_DIR / "method_throughput.json"
    out = json.loads(path.read_text()) if path.exists() else {}
    out.update(fresh)
    out.update(backend=dev.type, card=card,
               _provenance=configs.provenance(dev, card, args.commit))
    configs.write_results("method_throughput", out)
    bad = methods.failures(fresh, dev.type == "cuda")
    for b in bad:
        print(f"FAIL {b}", file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
