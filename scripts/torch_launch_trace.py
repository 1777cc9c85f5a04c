"""Where a small frame's time goes on one card: a profiler trace of kernel
C's launch loop on the c1 frame.

    python3 scripts/torch_launch_trace.py [--cpu]

Runs ``bench/configs.run_launch_trace``: 1000 calls of kernel C on the
256x256 RGBA frame at 2x, one frame per launch (``c1_256_gray_2x``'s
``pallas_mxu`` candidate) and eight per launch
(``c1_256_gray_2x_microbatch8``), each loop once without the profiler and
once under ``torch.profiler``. Prints per call: the loop's host time with
and without the profiler, the device ops' time and their share of the
loop's wall time (busy and idle), and the host ops' self time, in all and
the largest by name; with the card's name and power limit. Writes
``build/results/launch_trace.json``; exits 1 when a loop launches other
kernels than one of C per call. With ``--cpu`` it runs each loop's call
once and traces nothing. Imports nothing of JAX.
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
                    help="run each loop's call once; trace nothing")
    args = ap.parse_args(argv)
    dev, card = configs.device_and_card(args.cpu)
    table = configs.run_launch_trace(
        geo=configs.SMALL if args.cpu else configs.FULL, dev=dev, card=card,
        emit=labs.emit)
    configs.write_results("launch_trace", table)
    bad = [f"{key}: launches {r['launches']}, expected "
           f"{r['expected_launches']}"
           for key, r in table["loops"].items()
           if dev.type == "cuda" and r["launches"] != r["expected_launches"]]
    for b in bad:
        print(f"FAIL {b}", file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
