"""One run of one cell: set-up, the measured window, the check, the line.

The program under test is the PyTorch and CUDA port; the harness builds
the configuration's system (``configs/<config>.json``: ``system``) from
the port's serving module, hands it the traffic's frames and takes
nothing else from it but its results, its kernel names and its launch
counters.
"""

from __future__ import annotations

import collections
import dataclasses
import gc
import importlib
import math
import sys
import tempfile
import time

import numpy as np

from . import correctness, drive, spec, tracing, traffic

#: top-level module names that the port must not load (compared whole:
#: the port's own name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "bicubic_interpolation_model_tpu")
TRACE_ATTEMPTS = 3


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def percentile(values, q: float) -> float:
    """Nearest-rank percentile (q in (0, 1]) of all the values."""
    s = sorted(values)
    return s[max(0, math.ceil(q * len(s)) - 1)]


@dataclasses.dataclass
class Context:
    """What a metric reader reads."""

    cell: dict
    config: dict
    mix: dict
    setup_s: float
    window: drive.Window
    trace: tracing.Trace | None = None

    @property
    def frames(self) -> int:
        return self.window.completed


def out_shape(config: dict, mix: dict) -> tuple:
    h, w, c = mix["frame"]
    s = config["scale"]
    return (int(math.floor(h * s + 0.5)), int(math.floor(w * s + 0.5)), c)


def build_system(config: dict, device: str):
    sysdef = config["system"]
    args = dict(sysdef.get("args", {}))
    for key in sysdef.get("paths", ()):
        args[key] = str(spec.ROOT / args[key])
    cls = getattr(importlib.import_module(sysdef["module"]),
                  sysdef["class"])
    return cls(**args, device=device)


def warm(system, mix, pool, n, keep=0):
    """Serve ``n`` frames, holding up to ``keep`` results at a time from
    distinct host blocks (a grouped stream yields views of one block per
    group), as the window's sample may hold them."""
    frames = [pool[i % len(pool)] for i in range(n)]
    held = collections.deque(maxlen=max(1, keep))
    if mix["entry"] == "stream":
        outs = system.stream(iter(frames),
                             microbatch=mix.get("microbatch", "auto"))
    else:
        outs = (system(f) for f in frames)
    for out in outs:
        if not held or not np.may_share_memory(out, held[-1]):
            held.append(out)


def _counter_values(paths: dict) -> dict:
    out = {}
    for pattern, path in paths.items():
        module, attr = path.split(":")
        out[pattern] = getattr(importlib.import_module(module),
                               attr).launches
    return out


def _traced_window(system, mix, pool, seconds, shape, sample, layers,
                   counter_paths, log):
    """A traced window, taken again while its trace is incomplete or its
    launch counts disagree with the kernels' own counters."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    attempted = failed = 0
    with tempfile.TemporaryDirectory(prefix="bench_trace") as tmp:
        for attempt in range(1, TRACE_ATTEMPTS + 1):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                warm(system, mix, pool, mix["warmup_frames"])
                torch.cuda.synchronize()
                before = _counter_values(counter_paths)
                with record_function(tracing.WINDOW):
                    win = drive.run(mix, system, pool, seconds, shape,
                                    sample, span=True)
                after = _counter_values(counter_paths)
                torch.cuda.synchronize()
            path = f"{tmp}/trace{attempt}.json"
            prof.export_chrome_trace(path)
            del prof
            tr = tracing.read(path, layers)
            attempted += win.attempted
            failed += win.failed
            counts = {p: (after[p] - before[p], tr.kernel_count(p))
                      for p in counter_paths}
            agree = all(a == b for a, b in counts.values())
            log(f"trace {attempt}: {len(tr.kernels)} kernels, "
                f"{len(tr.launches)} launches, {tr.lost_launches()} "
                f"launches without their kernel; counters vs trace "
                f"{ {p: c for p, c in counts.items() if c != (0, 0)} }")
            if tr.complete() and agree:
                return win, tr, True, attempted, failed
    log(f"no complete trace in {TRACE_ATTEMPTS} attempts: the trace's "
        "metrics are not reported")
    return win, tr, False, attempted, failed


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool,
             t_start: float, device: str = "cuda", mix_override=None,
             log=lambda s: print(s, file=sys.stderr, flush=True)) -> dict:
    """The result line's object. ``mix_override`` replaces keys of the
    traffic mix (the tests run a cell's path at a small frame size)."""
    import torch
    bench = spec.benchmark()
    cell = spec.cell(bench, cell_name)
    config = spec.config(cell["config"])
    mix = spec.traffic(cell["traffic"])
    if mix_override:
        mix = traffic.check_mix({**mix, **mix_override})
    cuda = device == "cuda"
    shape = out_shape(config, mix)

    log(f"set-up: torch imported at {time.perf_counter() - t_start:.3f} s")
    if cuda:
        torch.zeros(1, device=device)
        log(f"set-up: cuda context at {time.perf_counter() - t_start:.3f} s")
    frames_pool = traffic.pool(mix, seed)
    system = build_system(config, device)
    log(f"set-up: port and {config['name']} loaded, frames made at "
        f"{time.perf_counter() - t_start:.3f} s")
    sample = drive.Sample(mix["sample"], seed)
    warm(system, mix, frames_pool, mix["warmup_frames"], mix["sample"])
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    gc.collect()
    gc.freeze()
    log(f"set-up: warm at {time.perf_counter() - t_start:.3f} s")

    tr, complete = None, False
    if trace:
        win, tr, complete, attempted, failed = _traced_window(
            system, mix, frames_pool, min(seconds, mix["trace_seconds"]),
            shape, sample, tracing.load_layers(spec.HERE / "layers"),
            spec.counters(), log)
        setup_s = float("nan")
    else:
        setup_s = time.perf_counter() - t_start
        win = drive.run(mix, system, frames_pool, seconds, shape, sample)
        attempted, failed = win.attempted, win.failed
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    loaded = forbidden_modules()
    if loaded:
        raise RuntimeError(f"the run loaded {loaded}")
    gc.unfreeze()
    del system
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    frames, pool_ids = sample.taken()
    correct, checks = correctness.judge(config, frames_pool, frames,
                                        pool_ids, failed, device)
    ctx = Context(cell, config, mix, setup_s, win,
                  tr if complete else None)
    metrics = {}
    for m in spec.metrics_of(bench, cell_name, trace):
        value = spec.reader(m["name"])(ctx)
        if value is None:
            if not trace:
                raise RuntimeError(f"{m['name']} read nothing")
            log(f"{m['name']}: nothing to read")
            continue
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell["chips"], "memory_peak_bytes": peak}
    out = {"correct": bool(correct), "attempted": attempted,
           "failed": failed, "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = tr.busy_s()
        dev["window_s"] = tr.window_s
        out["breakdown"] = tr.breakdown()
        unassigned = tr.unassigned()
        if unassigned:
            log(f"kernels of no layer: {unassigned}")
    out["checks"] = checks
    return out
