"""The BASELINE.json configurations on one card: every row held to the
float64 oracle at its full geometry, timed.

    python3 scripts/torch_bench_configs.py [--cpu] [--commit REV]

Counterpart of ``scripts/bench_configs.py`` (the TPU script). Runs
``bench/configs.run_configs``: configs 1, 2, 4 and 5 (256x256 at 2x, RGBA
and a true gray frame beside it; 512x512 at 4x; 3840x2160 RGBA at 4x;
1080x1920 at 2x) through kernels C and D, the faster passing one taking the
row; 256x256 frames eight to a launch of C; a batch of 64 256x256 frames in
three scale buckets, one launch of D each; four frame sizes at 2x through D
with plans cached per size; ``Upscaler.stream()`` over 16 fetched 1080p
frames. Prints each row with the card's name and power limit and writes
``build/results/bench_configs.json``, stamped with the card, torch, the
source revision (``--commit``, else ``git rev-parse HEAD`` where the
checkout has its history) and the date. Exits 1 when a row reads more than 1
u8 from the oracle, when a batch or stream frame differs from its own
launch, or (on the card) when a row launched other kernels than its own; it
falls back to no other impl. With ``--cpu`` it runs the plain versions at a
small size and measures nothing. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from bicubic_interpolation_model_tpu_torch.bench import (  # noqa: E402
    configs, labs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain versions at a small size; time "
                         "nothing")
    ap.add_argument("--commit", default=None,
                    help="the source revision to stamp (default: git "
                         "rev-parse HEAD where the checkout has history)")
    args = ap.parse_args(argv)
    dev, card = configs.device_and_card(args.cpu)
    table = configs.run_configs(
        geo=configs.SMALL if args.cpu else configs.FULL, dev=dev, card=card,
        emit=labs.emit)
    table["_provenance"] = configs.provenance(dev, card, args.commit)
    configs.write_results("bench_configs", table)
    bad = configs.failures(table["configs"], dev.type == "cuda")
    for b in bad:
        print(f"FAIL {b}", file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
