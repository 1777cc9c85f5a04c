"""Performance harness (counterpart of
``bicubic_interpolation_model_tpu/bench/harness.py``, after the reference's
``accuratePerformanceTest``, version3.0/utils/compare_performance.js:5-49).

Same shape: warmup runs, timed runs, CSV rows
``Run,Timestamp,Execution Time (ms),CPU Time (ms),Memory (MB)`` written to
``cp_performance/<item>/<item>_performance.csv``. PyTorch returns before the
card has done the work, so every run is fenced on the devices of the CUDA
tensors it returns (``torch.cuda.synchronize``): wall time measures the
work, not its enqueue.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pathlib
import time
from typing import Callable

import torch


@dataclasses.dataclass
class BenchResult:
    test_item: str
    wall_ms: list[float]
    cpu_ms: list[float]
    rss_mb: list[float]

    @property
    def best_ms(self) -> float:
        return min(self.wall_ms)

    @property
    def mean_ms(self) -> float:
        return sum(self.wall_ms) / len(self.wall_ms)


def _rss_mb() -> float:
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) / 1024.0
    except OSError:
        pass
    return 0.0


def _cuda_devices(out, found: set) -> set:
    if isinstance(out, torch.Tensor):
        if out.device.type == "cuda":
            found.add(out.device)
    elif isinstance(out, dict):
        for v in out.values():
            _cuda_devices(v, found)
    elif isinstance(out, (list, tuple)):
        for v in out:
            _cuda_devices(v, found)
    return found


def _block(out):
    """Wait for the devices of every CUDA tensor in ``out`` (a tensor, or
    lists, tuples and dicts of them); host values need no wait."""
    for dev in _cuda_devices(out, set()):
        torch.cuda.synchronize(dev)
    return out


def performance_test(func: Callable[[], object], *, test_item: str,
                     runs: int = 2, warmup: int = 2,
                     out_dir: str | os.PathLike | None = "cp_performance",
                     ) -> BenchResult:
    """Run ``func`` with ``warmup`` untimed runs (kernel builds, plan
    caches) then ``runs`` timed runs; optionally write the reference-schema
    CSV."""
    for _ in range(warmup):
        _block(func())

    rows = ["Run,Timestamp,Execution Time (ms),CPU Time (ms),Memory (MB)"]
    res = BenchResult(test_item, [], [], [])
    for i in range(runs):
        cpu0 = time.process_time()
        t0 = time.perf_counter()
        _block(func())
        wall = (time.perf_counter() - t0) * 1e3
        cpu = (time.process_time() - cpu0) * 1e3
        rss = _rss_mb()
        res.wall_ms.append(wall)
        res.cpu_ms.append(cpu)
        res.rss_mb.append(rss)
        rows.append(
            f"{i + 1},{datetime.datetime.now(datetime.UTC).isoformat()},"
            f"{wall:.2f},{cpu:.2f},{rss:.2f}"
        )

    if out_dir is not None:
        d = pathlib.Path(out_dir) / test_item
        d.mkdir(parents=True, exist_ok=True)
        (d / f"{test_item}_performance.csv").write_text("\n".join(rows) + "\n")
    return res
