"""Latency against frame size on one card, single and micro-batched.

    python3 scripts/torch_latency_curve.py [--cpu]

Counterpart of ``scripts/latency_curve.py`` (the TPU script). NxN RGBA
frames (N from 128 to 1024) at 4x bicubic through kernel C, one frame per
launch and ``round(4 * MICROBATCH_THRESHOLD_PX / N^2)`` frames per launch
(1 to 64, the JAX script's rule), per frame at the program-output boundary
(``bench/suite.bench_program_output``: every output a fresh tensor held
until the loop's end). Beside each size it prints whether the serving
policy (``serving.Upscaler.MICROBATCH_THRESHOLD_PX``, kept from the JAX
package) groups frames of that size and whether grouping was faster on
this card, with the card's name and power limit. Each single output is held
to the float64 oracle, each batched frame to its own launch. Writes
``build/results/latency_curve.json``; exits 1 on a failed check. With
``--cpu`` it runs the plain versions at a small size and measures nothing.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from bicubic_interpolation_model_tpu_torch.bench import (  # noqa: E402
    configs, labs)
from bicubic_interpolation_model_tpu_torch.serving import (  # noqa: E402
    Upscaler)


def _fmt(v, spec):
    return "-" if v is None else format(v, spec)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain versions at a small size; time "
                         "nothing")
    args = ap.parse_args(argv)
    dev, card = configs.device_and_card(args.cpu)
    threshold = Upscaler.MICROBATCH_THRESHOLD_PX
    table = configs.run_latency_curve(
        threshold, geo=configs.SMALL if args.cpu else configs.FULL, dev=dev,
        card=card, emit=labs.emit)
    print(f"# {card}; MICROBATCH_THRESHOLD_PX = {threshold}")
    for size, r in table["rows"].items():
        print(f"{size}: single {_fmt(r['single_ms'], '8.4f')} ms "
              f"({_fmt(r['single_gpix_s'], '6.1f')} GPix/s)  "
              f"batch[{r['microbatch']}] "
              f"{_fmt(r['batched_ms_per_frame'], '8.4f')} ms/frame "
              f"({_fmt(r['batched_gpix_s'], '6.1f')} GPix/s)  "
              f"policy batches: {r['policy_batches']}  "
              f"batching faster: {r['batching_faster']}", flush=True)
    configs.write_results("latency_curve", table)
    bad = configs.failures(table["rows"], dev.type == "cuda")
    for b in bad:
        print(f"FAIL {b}", file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
