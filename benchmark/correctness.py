"""What decides ``correct``: the window's own results against the plain
reference.

The sample of results that the window copied aside (drawn from the seed
over all its results) is compared byte for byte with the float64
reference of the same pool frame, computed after the window has closed
and the program's state is freed. The number compared is the worst
sampled frame's share of bytes that differ from the reference's, held to
the configuration's ``limits.mismatch_share``; every frame of the window
has to have come back whole (``failed`` 0).
"""

from __future__ import annotations

import importlib

import numpy as np
import torch


def reference(config: dict):
    return importlib.import_module(
        f"benchmark.reference.{config['reference']}")


def mismatch_share(got: np.ndarray, want: np.ndarray) -> float:
    if got.shape != want.shape:
        return 1.0
    return float(np.count_nonzero(got != want)) / got.size


def judge(config, pool, frames, pool_ids, failed,
          device) -> tuple[bool, dict]:
    """(correct, the numbers compared with their limits)."""
    ref = reference(config)
    state = ref.prepare(config, device)
    worst = 1.0 if not len(pool_ids) else 0.0
    by_pool: dict = {}
    for i, pid in enumerate(pool_ids):
        by_pool.setdefault(pid, []).append(i)
    for pid, idx in sorted(by_pool.items()):
        frame = torch.as_tensor(np.ascontiguousarray(pool[pid])).to(device)
        want = ref.run(state, frame, "float64").cpu().numpy()
        for i in idx:
            worst = max(worst, mismatch_share(frames[i], want))
    checks = {
        "mismatch_share": {"value": worst, "rule": "<=",
                           "limit": config["limits"]["mismatch_share"]},
        "failed_frames": {"value": failed, "rule": "<=", "limit": 0},
        "sampled_frames": {"value": len(pool_ids), "rule": ">=",
                           "limit": 1},
    }
    ok = (worst <= checks["mismatch_share"]["limit"] and failed == 0
          and len(pool_ids) >= 1)
    return ok, checks
