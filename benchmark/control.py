"""The control of the correctness check: the plain reference put in the
program's place and computed in TF32, the precision below the float32
(TF32 off) that both configurations state. Its results have to fail the
check that sound runs of the program pass.

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3

makes each seed's pool of frames as a run of the cell does, at the cell's
own size, draws as many of them as a run samples, and prints per seed the
worst frame's share of bytes in which the TF32 reference differs from the
float64 one, beside the configuration's limit: the control's reading
(its smallest over the seeds is the limit's upper reading). It is not part
of a benchmark run.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import random
import sys


def control_readings(cell_name, seeds, device="cuda", mix_override=None):
    from benchmark import correctness, spec, traffic
    import torch
    bench = spec.benchmark()
    cell = spec.cell(bench, cell_name)
    config = spec.config(cell["config"])
    mix = spec.traffic(cell["traffic"])
    if mix_override:
        mix = traffic.check_mix({**mix, **mix_override})
    ref = correctness.reference(config)
    state = ref.prepare(config, device)
    out = []
    for seed in seeds:
        pool = traffic.pool(mix, seed)
        rng = random.Random(seed)
        ids = [rng.randrange(len(pool)) for _ in range(mix["sample"])]
        worst = 0.0
        for pid in sorted(set(ids)):
            frame = torch.as_tensor(pool[pid]).to(device)
            want = ref.run(state, frame, "float64").cpu().numpy()
            got = ref.run(state, frame, "tf32").cpu().numpy()
            worst = max(worst, correctness.mismatch_share(got, want))
        out.append({"workload": cell_name, "seed": seed,
                    "control_mismatch_share": worst,
                    "limit": config["limits"]["mismatch_share"],
                    "frames": len(set(ids))})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device is visible", file=sys.stderr)
        return 2
    for row in control_readings(args.workload, args.seeds):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
