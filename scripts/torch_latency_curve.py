"""Latency against frame size on one card, one frame a launch and grouped,
for the classical and the learned path: the evidence that sets
``serving``'s ``MICROBATCH_THRESHOLD_PX``.

    python3 scripts/torch_latency_curve.py [--cpu] [--commit REV]

Counterpart of ``scripts/latency_curve.py`` (the TPU script). Classical:
NxN RGBA frames (N from 128 to 1024) at 4x bicubic through kernel C.
Learned: NxN RGBA frames (N from 64 to 512) through
``ModelUpscaler("model/wp-1e-3-120")`` (kernel A; kernel B on single
frames). Each size runs one frame a launch against the group that
``stream(microbatch="auto")`` makes below its threshold
(``serving.group_size`` with no threshold: ``round(2**20 / N^2)`` frames
classical, ``round(2**18 / N^2)`` learned, at most 64), per frame at the
program-output boundary (``bench/suite.bench_program_output``) and as
served ``stream()`` frames with their fetches (host clock: after an
untimed pass of each mode, the median of five passes of each mode, in
turns, each at least 0.25 s; every pass and each mode's spread, slowest
over fastest pass, are kept in the row beside this call's reading by the
rule, ``batching_wins``). Beside each
size it prints whether the serving policy groups that size now and
whether grouping won on this card (``bench/configs.batching_wins``), with
the card's name and power limit; at the end, the thresholds that this
call alone gives (``bench/configs.threshold_from``). Each classical single
output is held to the float64 oracle and each batched frame to its own
launch; each learned single frame to the plain graph tail and each grouped
frame to its own launch, ≤1 u8. Writes ``build/results/latency_curve.json``
stamped with the card, torch, the source revision (``--commit``, else
``git rev-parse HEAD`` where the checkout has its history) and the date;
exits 1 on a failed check. With ``--cpu`` it runs the plain versions at a
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


def _fmt(v, spec):
    return "-" if v is None else format(v, spec)


def print_table(name, table, timed):
    print(f"# {name}: MICROBATCH_THRESHOLD_PX = "
          f"{table['microbatch_threshold_px']}, group target "
          f"{table['target_px']} px a launch")
    for size, r in table["rows"].items():
        policy = configs.size_px(size) < table["microbatch_threshold_px"]
        wins = configs.batching_wins(r) if timed else None
        print(f"{size}: single {_fmt(r['single_ms'], '8.4f')} ms "
              f"({_fmt(r['single_gpix_s'], '6.1f')} GPix/s)  "
              f"batch[{r['microbatch']}] "
              f"{_fmt(r['batched_ms_per_frame'], '8.4f')} ms/frame  "
              f"served {_fmt(r['served_single_ms_per_frame'], '7.4f')} / "
              f"grouped {_fmt(r['served_grouped_ms_per_frame'], '7.4f')} "
              f"ms/frame (spread {_fmt(r['served_single_spread'], '.2f')} / "
              f"{_fmt(r['served_grouped_spread'], '.2f')})  "
              f"policy groups: {policy}  batching wins: {wins}",
              flush=True)
    if timed:
        print(f"# {name}: this call alone gives MICROBATCH_THRESHOLD_PX = "
              f"{configs.threshold_from([table['rows']])}", flush=True)


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
    table = configs.run_latency_curve(
        geo=configs.SMALL if args.cpu else configs.FULL, dev=dev,
        card=card, emit=labs.emit)
    table["_provenance"] = configs.provenance(dev, card, args.commit)
    timed = dev.type == "cuda"
    print(f"# {card}")
    print_table("classical (kernel C)", table, timed)
    print_table(f"learned ({configs.LEARNED_MODEL})", table["learned"],
                timed)
    configs.write_results("latency_curve", table)
    bad = (configs.failures(table["rows"], timed)
           + configs.failures(table["learned"]["rows"], timed))
    for b in bad:
        print(f"FAIL {b}", file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
