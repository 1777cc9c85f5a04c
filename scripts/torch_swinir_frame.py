"""Where SwinIR-M's served frame spends the card's time.

    python3 scripts/torch_swinir_frame.py [--frames N]

Prints one JSON line, ``breakdown``, with the card's name and power limit:
``N`` served cell frames (``ModelUpscaler`` on
``benchmark/configs/swinir-m-realsr-x4``, default 3) under
``torch.profiler`` after two untraced: device ms a frame by part: the
window attention kernel, the linears (every GEMM kernel whose name holds
neither ``conv`` nor ``implicit``: the linear kernel
``linear_xmma_gemm_kernel``, with fc1's GELU and the block's residual adds
in its epilogue, or cuBLAS's on the plain route), the convs outside the
HR stage (cuDNN: conv_first, the RSTBs', conv_after_body,
conv_before_upsample), the HR stage (every kernel launched inside the
``model.upsample`` span: the nearest upsamples, the conv kernel,
conv_last), and the rest (LayerNorm, padding, the mean, the crop, the
RSTB and trunk residual adds, copies, rounding; its twelve largest kernels
by name, and the linears' kernels by name);
device busy and window ms a frame, the traced and untraced host ms a
frame, and the peak memory of a frame. The kernels' own times beside their
bounds, their plain versions and the library's are ``chip_smoke.py``'s
(``check_window_attention``, ``check_linear_tc``).

Without a card it exits 2. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from benchmark import traffic  # noqa: E402

CELL_DIR = ROOT / "benchmark" / "configs" / "swinir-m-realsr-x4"


def card() -> dict:
    q = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True)
    return {"name": torch.cuda.get_device_name(0),
            "nvidia_smi": q.stdout.strip()}


def _part(name: str) -> str:
    if "window_attention_kernel" in name:
        return "attention"
    low = name.lower()
    if "gemm" in low and "implicit" not in low and "conv" not in low:
        return "linears"
    if any(p in low for p in ("conv", "fprop", "winograd", "implicit_gemm",
                              "cudnn", "nchwtonhwc", "nhwctonchw")):
        return "convs"
    return "rest"


def breakdown(dev, frames: int) -> dict:
    from torch.profiler import ProfilerActivity, profile, record_function

    from bicubic_interpolation_model_tpu_torch.serving import ModelUpscaler
    up = ModelUpscaler(str(CELL_DIR))
    pool = traffic.pool({"frame": [339, 510, 3], "pool": 2}, 2147483711)
    for f in pool:
        up(f)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(frames):
        up(pool[i % 2])
    untraced = (time.perf_counter() - t0) * 1e3 / frames
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("window"):
            t0 = time.perf_counter()
            for i in range(frames):
                up(pool[i % 2])
            traced = (time.perf_counter() - t0) * 1e3 / frames
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    with tempfile.TemporaryDirectory() as tmp:
        path = pathlib.Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    x = [e for e in events if e.get("ph") == "X" and "dur" in e]
    win = next(e for e in x if e.get("name") == "window"
               and e.get("cat") == "user_annotation")
    t0w, t1w = float(win["ts"]), float(win["ts"]) + float(win["dur"])
    upsample = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                for e in x if e.get("name") == "model.upsample"
                and e.get("cat") == "user_annotation"]
    launched_in_upsample = {
        (e.get("args") or {}).get("correlation") for e in x
        if e.get("cat") in ("cuda_runtime", "cuda_driver")
        and any(a <= float(e["ts"]) <= b for a, b in upsample)}
    parts: dict = {}
    rest: dict = {}
    linears: dict = {}
    busy = []
    for e in x:
        if e.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        busy.append((float(e["ts"]), float(e["ts"]) + float(e["dur"])))
        if e["cat"] != "kernel":
            part = "copies"
        elif (e.get("args") or {}).get("correlation") in \
                launched_in_upsample:
            part = "hr_stage"
        else:
            part = _part(e["name"])
        parts[part] = parts.get(part, 0.0) + float(e["dur"])
        if part in ("rest", "linears"):
            names = rest if part == "rest" else linears
            names[e["name"][:90]] = names.get(e["name"][:90], 0.0) + float(
                e["dur"])
    merged = []
    for a, b in sorted(busy):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy_ms = sum(b - a for a, b in merged) / 1e3 / frames
    return {"frames": frames, "untraced_ms": untraced, "traced_ms": traced,
            "window_ms": (t1w - t0w) / 1e3 / frames, "busy_ms": busy_ms,
            "device_ms": {k: v / 1e3 / frames for k, v in
                          sorted(parts.items(), key=lambda kv: -kv[1])},
            "rest_ms": {k: v / 1e3 / frames for k, v in sorted(
                rest.items(), key=lambda kv: -kv[1])[:12]},
            "linears_ms": {k: v / 1e3 / frames for k, v in sorted(
                linears.items(), key=lambda kv: -kv[1])},
            "peak_bytes_above_model": peak}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device is visible", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    info = card()
    print(json.dumps({"breakdown": breakdown(dev, args.frames),
                      "card": info}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
