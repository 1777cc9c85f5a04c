"""Where the host's time and the card's idle time go inside the serving
path, by the port's spans (``utils/profiling.span``), with what the spans
cost while a profiler records.

    python3 scripts/torch_span_split.py [--cpu] [--frames N]

Four serving paths, each on a seeded pool of distinct frames: the
learned 4x model (``ModelUpscaler("model/wp-1e-3-120")``) through
``__call__`` on 339x510 RGBA frames (DIV2K x4 LR) and through
``stream(microbatch="auto")`` on 540x960 RGBA frames, classical bicubic
4x (``Upscaler``) through ``__call__`` on 1080x1920 RGBA frames, and the
published ESRGAN generator
(``ModelUpscaler("benchmark/configs/esrgan-rrdbnet-x4")``, whose
``model.step`` holds ``model.trunk`` and ``model.upsample``) through
``__call__`` on 339x510 RGB frames. Per path,
after a warm-up: ``untraced_ms``, host ms a frame with no profiler; then
under ``torch.profiler`` (host and card), after one traced window that
is not counted (on the card the first profiled window of each path ran
10-20% slower than the next), two windows with the spans and two with
them held off (their gate read as "no profiler"), in the order on, off,
off, on, each of ``--frames`` frames (default 400, 16 for the ESRGAN
path, 3 with ``--cpu``), each call under
``record_function("__call__")`` or each ``next()`` under
``record_function("stream.next")``. Prints per path one JSON line: the host ms a frame of
each traced window (``traced_ms``, ``traced_no_spans_ms``) and, from the
first window with spans, ``profiling.span_split`` per frame: each span's
self ms and the card's idle ms while it was the innermost port span, the
idle ms under no port span, busy and window ms; with the card's name and
power limit; for the ESRGAN path also ``dense_blocks``, the dense blocks a
frame that ``RRDBNet`` served buffered and concatenated in the untraced
window. With ``--cpu`` it runs each path at 12x16 (the path's
channels) on the CPU, where no time is the card's. Imports nothing of
JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import statistics
import sys
import tempfile
import time
import types
from unittest import mock

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.profiler import (ProfilerActivity, profile,  # noqa: E402
                            record_function)

from bicubic_interpolation_model_tpu_torch.bench import labs  # noqa: E402
from bicubic_interpolation_model_tpu_torch.models.esrgan import (  # noqa: E402
    RRDBNet)
from bicubic_interpolation_model_tpu_torch.serving import (  # noqa: E402
    ModelUpscaler, Upscaler)
from bicubic_interpolation_model_tpu_torch.utils import (  # noqa: E402
    profiling)

#: the checkpoint of each model path
MODELS = {"learned": ROOT / "model" / "wp-1e-3-120",
          "esrgan": ROOT / "benchmark" / "configs" / "esrgan-rrdbnet-x4"}
#: name: (server, entry, frame, pool, frames a window on the card)
PATHS = {"wp_div2k_call": ("learned", "call", (339, 510, 4), 16, 400),
         "bicubic_1080p_call": ("bicubic", "call", (1080, 1920, 4), 8, 400),
         "wp_540p_stream": ("learned", "stream", (540, 960, 4), 16, 400),
         "esrgan_div2k_call": ("esrgan", "call", (339, 510, 3), 8, 16)}
CPU_FRAME = (12, 16)
CPU_FRAMES = 3
WARM = 32


def _serve(server, entry, pool, n, mark=contextlib.nullcontext):
    """Serve ``n`` frames of ``pool``; host seconds."""
    frames = [pool[k % len(pool)] for k in range(n)]
    t0 = time.perf_counter()
    if entry == "call":
        for f in frames:
            with mark("__call__"):
                server(f)
    else:
        it = server.stream(iter(frames), microbatch="auto")
        while True:
            with mark("stream.next"):
                if next(it, None) is None:
                    break
    return time.perf_counter() - t0


def _traced(server, entry, pool, n, dev, spans_on, tmp):
    """Host seconds of one traced window of ``n`` frames, and its trace's
    events when ``spans_on``."""
    gate = contextlib.nullcontext() if spans_on else mock.patch.object(
        profiling, "_autograd_profiler",
        types.SimpleNamespace(_is_profiler_enabled=False))
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if dev.type == "cuda" else [])
    with gate, profile(activities=acts) as prof:
        _serve(server, entry, pool, min(n, 8))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        with record_function("window"):
            s = _serve(server, entry, pool, n, mark=record_function)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    if not spans_on:
        return s, None
    path = pathlib.Path(tmp) / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    path.unlink()
    return s, events


def run_path(name, dev, frames=None, seed=0) -> dict:
    kind, entry, frame, n_pool, card_frames = PATHS[name]
    if dev.type != "cuda":
        frame = (*CPU_FRAME, frame[2])
    frames = frames or (card_frames if dev.type == "cuda" else CPU_FRAMES)
    server = (ModelUpscaler(str(MODELS[kind]), scale=4, device=dev)
              if kind in MODELS else
              Upscaler(scale=4, method="bicubic", device=dev))
    pool = np.random.default_rng(seed).integers(
        0, 256, (n_pool, *frame), dtype=np.uint8)
    pool = [np.ascontiguousarray(f) for f in pool]
    _serve(server, entry, pool, min(frames, WARM))
    blocks = (RRDBNet.buffered_blocks, RRDBNet.concatenated_blocks)
    untraced = _serve(server, entry, pool, frames)
    blocks = [(n - n0) / frames for n, n0 in zip(
        (RRDBNet.buffered_blocks, RRDBNet.concatenated_blocks), blocks)]
    on, off, split = [], [], None
    with tempfile.TemporaryDirectory(prefix="span_split") as tmp:
        _traced(server, entry, pool, frames, dev, False, tmp)
        for spans_on in (True, False, False, True):
            s, events = _traced(server, entry, pool, frames, dev, spans_on,
                                tmp)
            (on if spans_on else off).append(s * 1e3 / frames)
            if events is not None and split is None:
                split = profiling.span_split(events, "window")
    ms = lambda s: s * 1e3 / frames
    extra = ({"dense_blocks": dict(zip(("buffered", "concatenated"), blocks))}
             if kind == "esrgan" else {})
    return {"path": name, "frame": list(frame), "frames": frames,
            "untraced_ms": untraced * 1e3 / frames,
            "traced_ms": on, "traced_no_spans_ms": off,
            "spans_cost_ms": statistics.mean(on) - statistics.mean(off),
            "window_ms": ms(split["window_s"]),
            "busy_ms": ms(split["busy_s"]), "idle_ms": ms(split["idle_s"]),
            "idle_no_span_ms": ms(split["idle_no_span_s"]),
            "spans": {k: {"count": v["count"] / frames,
                          "self_ms": ms(v["self_s"]),
                          "idle_ms": ms(v["idle_s"])}
                      for k, v in split["spans"].items()}, **extra}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="run each path at 12x16 on the CPU")
    ap.add_argument("--frames", type=int, default=None,
                    help="frames a window (default: the path's own, 3 "
                         "with --cpu)")
    ap.add_argument("--path", choices=sorted(PATHS), action="append",
                    help="the paths to run (default: all)")
    args = ap.parse_args(argv)
    dev, card = labs.lab_device(args.cpu)
    for name in args.path or PATHS:
        row = run_path(name, dev, args.frames)
        row["card"] = card
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
