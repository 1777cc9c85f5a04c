"""Run one cell of the port's benchmark and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s>
                             --trace <0|1>

from the root of a checkout. The last line of standard output is one
JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` also ``breakdown``, and last ``checks``:
each number that decided ``correct`` beside its limit, which also close
standard error). Without a CUDA device, or with fewer than the cell asks
for, it prints no result and exits 2.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _pin_caches() -> None:
    """Every compiler cache at a fixed path inside the checkout, so the
    first run there builds and every later one finds it."""
    cache = ROOT / "build" / "bench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _pin_caches()
    sys.path.insert(0, str(ROOT))
    from benchmark import harness, spec
    cell = spec.cell(spec.benchmark(), args.workload)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device is visible", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA devices, "
              f"{torch.cuda.device_count()} are visible", file=sys.stderr)
        return 2
    out = harness.run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), T_START)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} {c['rule']} {c['limit']!r}",
              file=sys.stderr)
    print(f"correct: {out['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
