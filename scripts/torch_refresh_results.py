#!/usr/bin/env python3
"""Re-run every producer of the port's card record and commit its tables,
as written, to ``results_torch/``.

    python3 scripts/torch_refresh_results.py [--timeout S] [--commit REV]
    python3 scripts/torch_refresh_results.py --cpu [--only a,b] [--skip a,b]

Counterpart of ``scripts/refresh_results.py`` (the TPU refresh). Each
producer runs as its own subprocess with a time limit, so a crash in one
cannot take down the rest, and each stamps its own table (``_provenance``:
backend, the card's name and power limit, torch and CUDA, ``--commit``,
the code's ``bench/configs.source_sha256`` and the date). Sections:

  method_throughput  scripts/torch_method_throughput.py → method_throughput.json
  bench_configs      scripts/torch_bench_configs.py     → bench_configs.json
  latency_curve      scripts/torch_latency_curve.py, three separate calls
                     → latency_curve_call{1,2,3}.json (the serving policy's
                     rule reads three)
  packed_tail        scripts/torch_packed_tail_lab.py   → packed_tail_lab.json
  adaptive_probe     scripts/torch_adaptive_probe_lab.py → adaptive_probe_lab.json

Before each call the table it writes under ``build/`` is deleted (so
``method_throughput`` runs every section on an empty table). A section's
files are copied byte for byte, never edited, and only when every call of
the section exited 0 and its table names backend ``cuda``, an NVIDIA card
with its power limit and this checkout's ``source_sha256``; anything else
is refused. Before it runs, the script prints each committed file's
``source_sha256`` beside this checkout's, fresh or stale. Without a card it
exits 1. With ``--cpu`` each section runs its producer's own ``--cpu``
path (plain versions, small sizes, nothing timed), each table is checked
for its ``cpu`` stamp, and nothing is copied; ``--only`` and ``--skip``
pick sections there alone, since a card run always runs every section:
a part of a snapshot copied beside the rest of an older one would leave
``results_torch/`` with two digests. Exits 1 if any section failed.

The TPU refresh's ``train_modes`` section and the quality table read the
DIV2K HR images, which the repository does not hold: they are no sections
here until it does. README's "Measured results on the card" is rendered
from these files by ``scripts/torch_render_readme_results.py``. Imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from bicubic_interpolation_model_tpu_torch.bench import configs  # noqa: E402


@dataclasses.dataclass(frozen=True)
class Section:
    """A producer: its script, the table it writes (from the root), that
    table's copy in ``results_torch/`` for each separate call, and the
    arguments its ``--cpu`` run adds."""
    script: str
    writes: str
    commits: tuple
    cpu_args: tuple = ()


SECTIONS = {
    "method_throughput": Section("scripts/torch_method_throughput.py",
                                 "build/results/method_throughput.json",
                                 ("method_throughput.json",)),
    "bench_configs": Section("scripts/torch_bench_configs.py",
                             "build/results/bench_configs.json",
                             ("bench_configs.json",)),
    "latency_curve": Section("scripts/torch_latency_curve.py",
                             "build/results/latency_curve.json",
                             tuple(f"latency_curve_call{i}.json"
                                   for i in (1, 2, 3))),
    "packed_tail": Section("scripts/torch_packed_tail_lab.py",
                           "build/labs/packed_tail_lab.json",
                           ("packed_tail_lab.json",)),
    "adaptive_probe": Section("scripts/torch_adaptive_probe_lab.py",
                              "build/labs/adaptive_probe_lab.json",
                              ("adaptive_probe_lab.json",),
                              ("--h", "24", "--w", "40")),
}


def refusal(table: dict, sha: str, cpu: bool) -> str | None:
    """Why ``table`` may not stand for this checkout's run (None if it
    may): its stamp must name this checkout's ``sha`` and backend
    ``cpu`` for a ``--cpu`` run, else ``cuda`` and an NVIDIA card with
    its power limit in watts."""
    prov = table.get("_provenance") or {}
    if prov.get("source_sha256") != sha:
        return f"source_sha256 {prov.get('source_sha256')}, not {sha}"
    if cpu:
        return None if prov.get("backend") == "cpu" else \
            f"backend {prov.get('backend')!r}, not 'cpu'"
    if prov.get("backend") != "cuda":
        return f"backend {prov.get('backend')!r}, not 'cuda'"
    name, _, power = (prov.get("card") or "").rpartition(", ")
    if not (name.startswith("NVIDIA ") and power.endswith(" W")):
        return f"card {prov.get('card')!r} names no NVIDIA card and limit"
    return None


def run_section(name: str, sec: Section, args, sha: str) -> str:
    """Every call of ``sec``; its files copied to ``results_torch/`` when
    all passed (not with ``--cpu``). Returns "ok" or why it failed."""
    cmd = [sys.executable, str(ROOT / sec.script)]
    if args.cpu:
        cmd += ["--cpu", *sec.cpu_args]
    if args.commit:
        cmd += ["--commit", args.commit]
    written = ROOT / sec.writes
    kept = []
    for i, dest in enumerate(sec.commits, 1):
        print(f"\n=== {name} call {i}/{len(sec.commits)}: "
              f"{' '.join(cmd[1:])} ===", flush=True)
        written.unlink(missing_ok=True)
        try:
            rc = subprocess.run(cmd, cwd=ROOT, timeout=args.timeout,
                                stdin=subprocess.DEVNULL).returncode
        except subprocess.TimeoutExpired:
            return f"FAILED: call {i} over {args.timeout} s"
        if rc != 0:
            return f"FAILED: call {i} rc={rc}"
        if not written.exists():
            return f"FAILED: call {i} wrote no {sec.writes}"
        data = written.read_bytes()
        try:
            why = refusal(json.loads(data), sha, args.cpu)
        except json.JSONDecodeError as e:
            why = f"{sec.writes} is no JSON: {e}"
        if why:
            return f"REFUSED: call {i}: {why}"
        kept.append((dest, data))
    if not args.cpu:
        configs.CARD_RESULTS_DIR.mkdir(exist_ok=True)
        for dest, data in kept:
            (configs.CARD_RESULTS_DIR / dest).write_bytes(data)
            print(f"copied {sec.writes} -> results_torch/{dest}", flush=True)
    return "ok"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default="",
                    help="comma list of sections (with --cpu)")
    ap.add_argument("--skip", default="",
                    help="comma list of sections (with --cpu)")
    ap.add_argument("--timeout", type=int, default=1800,
                    help="wall-clock limit of each call (s)")
    ap.add_argument("--commit", default=None,
                    help="the source revision every table is stamped with "
                         "(default: each producer's git rev-parse HEAD)")
    ap.add_argument("--cpu", action="store_true",
                    help="run each producer's --cpu path and check its "
                         "stamp; copy nothing")
    args = ap.parse_args(argv)
    only = set(filter(None, args.only.split(",")))
    skip = set(filter(None, args.skip.split(",")))
    bad = (only | skip) - set(SECTIONS)
    if bad:
        ap.error(f"unknown sections: {sorted(bad)}")
    if (only or skip) and not args.cpu:
        ap.error("--only and --skip go with --cpu: a card run refreshes "
                 "every section, so results_torch/ stays one snapshot")
    if not args.cpu and not torch.cuda.is_available():
        print("torch_refresh_results: no CUDA device is visible; the "
              "record is measured on the card (--cpu checks the producers' "
              "plain paths and copies nothing)", file=sys.stderr)
        return 1

    sha = configs.source_sha256()
    print(f"this checkout's source_sha256: {sha}")
    for fname, (got, state) in configs.freshness(sha).items():
        print(f"  results_torch/{fname}: {got} {state}")
    status = {}
    for name, sec in SECTIONS.items():
        if (only and name not in only) or name in skip:
            continue
        status[name] = run_section(name, sec, args, sha)
        print(f"=== {name}: {status[name]} ===", flush=True)

    print("\nsummary:")
    for k, v in status.items():
        print(f"  {k:>18}: {v}")
    return 1 if any(v != "ok" for v in status.values()) else 0


if __name__ == "__main__":
    sys.exit(main())
