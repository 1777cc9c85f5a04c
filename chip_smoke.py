"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from
``bicubic_interpolation_model_tpu_torch/csrc``, holds each against its plain
PyTorch version on the card, serves frames through the port's
``ModelUpscaler`` (learned SR on the committed WeightPredictor checkpoints
at 348x510 -> 4x RGBA), checks launch counts and outputs, and times the
kernels, their plain versions and the served frame with CUDA events.

Each phase prints one JSON line; any failure raises (exit code != 0). The
line before the last lists every ported kernel with its numbers; the last
line is ``{"ok": true, "device": {...}}``. Without a CUDA device, or
without the repository beside it, the script fails and prints no result.
Imports nothing of JAX.
"""

from __future__ import annotations

import itertools
import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
GEOMETRIES = [(24, 40, 4), (19, 37, 4), (13, 9, 3), (8, 128, 1),
              (348, 510, 4)]
FRAME = (348, 510)                  # LR frame of the 0020 image, 4x -> 1392x2040
HBM_BYTES_PER_S = 3.35e12           # H100 SXM, NVIDIA data sheet
F32_FLOP_PER_S = 67e12              # H100 SXM f32 outside the tensor cores


def emit(obj):
    print(json.dumps(obj), flush=True)


def card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else "nvidia-smi unavailable"


def time_ms(fn, iters=1, runs=20, warmup=3):
    """Median over ``runs`` of the per-call ms of ``iters`` back-to-back
    calls between two CUDA events (many launches per pair for short
    kernels, so the events' own overhead does not dominate)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / iters)
    return statistics.median(times)


def rotating(fn, inputs):
    """``fn`` over the inputs in turn: with more input bytes than the 50 MB
    L2, each call reads its input from HBM, as a served frame does."""
    it = itertools.cycle(inputs)
    return lambda: fn(*next(it))


def device_ms(fn, n=20, warmup=3):
    """Device time per call: the summed durations of the kernels and copies
    that ``n`` calls put on the card, from a torch.profiler trace (host
    launch cost excluded). None if the trace holds no device events."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        return None
    return sum(e.time_range.end - e.time_range.start for e in dev) / 1e3 / n


def diff_u8(a, b):
    a = a.to(torch.int64)
    b = b.to(torch.int64)
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} vs {tuple(b.shape)}")
    d = (a - b).abs()
    return int(d.max()), float((d != 0).double().mean())


def wp_tail_params(rng, dev):
    """Random WeightPredictor tail params (upsample, attention, offset,
    conv_out) made by numpy from a seed."""
    n = lambda *s: torch.as_tensor(rng.normal(0, 0.25, s).astype(np.float32),
                                   device=dev)
    return {"upsample": {"kernel": n(4, 4, 16, 32), "bias": n(16)},
            "conv_att": {"kernel": n(1, 1, 16, 1), "bias": n(1)},
            "conv_off": {"kernel": n(1, 1, 2, 16), "bias": n(16)},
            "conv_out": {"kernel": n(3, 3, 32, 16) * 0.4, "bias": n(16)}}


def tail_case(h, w, c, dev, seed):
    from bicubic_interpolation_model_tpu_torch.models.inference import (
        _tail_operands)
    rng = np.random.default_rng(seed)
    p = wp_tail_params(rng, dev)
    y = torch.as_tensor(rng.normal(0, 0.5, (1, h, w, 32)).astype(np.float32),
                        device=dev)
    lr = torch.as_tensor(rng.integers(0, 256, (1, h, w, c)).astype(
        np.float32), device=dev)
    ops = _tail_operands(p, 4, "train")
    return (y, lr, p["conv_out"]["kernel"], p["conv_out"]["bias"], *ops)


def tail_bound(h, w, c, y_bytes):
    """Least time of the fused tail at [h, w, c]: bytes (features, pixels,
    output words read/written once) over HBM rate, useful f32 FLOPs over
    the f32 peak. The FLOPs are multiply-adds of the upsample (256
    up-lanes), the attention dot, conv_out over the 16 gated up-lanes of
    each of 9 taps x 16 phases (its offset lanes are an in-image flag times
    a constant per tap and phase, so they cost no products per pixel) and
    the tap apply."""
    m = h * w
    nbytes = m * 32 * y_bytes + m * c * 4 + m * 16 * 4
    flops = 2 * m * (32 * 256 + 256 + 16 * 9 * 16 * 16 + 16 * 16 * c)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), nbytes, flops


def profile_served_frames(up, frame, n):
    """Device time by kernel name and the device's busy share over ``n``
    served frames (``ModelUpscaler.__call__`` with the host fetch), from
    one torch.profiler trace."""
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("serve"):
            for _ in range(n):
                up(frame)
        torch.cuda.synchronize()
    events = prof.events()
    window = [e for e in events if e.name == "serve"][0].time_range
    dev = [e for e in events if e.name != "serve"
           and e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        return {"device_events": 0, "note": "no device time in the trace"}
    busy, end = 0.0, None
    by_name: dict = {}
    for e in sorted(dev, key=lambda e: e.time_range.start):
        a, b = e.time_range.start, e.time_range.end
        by_name[e.name] = by_name.get(e.name, 0.0) + (b - a)
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    span = window.end - window.start
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    named = lambda key: sum(v for k, v in by_name.items() if key in k)
    return {"frames": n, "host_ms_per_frame": span / 1e3 / n,
            "device_busy_ms_per_frame": busy / 1e3 / n,
            "device_idle_share": 1.0 - busy / span,
            "packed_tail_fused_ms_per_frame":
                named("packed_tail_fused_kernel") / 1e3 / n,
            "interleave_planar_u32_ms_per_frame":
                named("interleave_kernel") / 1e3 / n,
            "device_ms_per_frame_by_kernel": {
                k[:80]: v / 1e3 / n for k, v in top}}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    if not (ROOT / "bicubic_interpolation_model_tpu_torch").is_dir():
        print("chip_smoke: the port's package is not beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from bicubic_interpolation_model_tpu_torch.models.inference import (
        super_resolve)
    from bicubic_interpolation_model_tpu_torch.ops import interleave as ilv
    from bicubic_interpolation_model_tpu_torch.ops import packed_tail as pt
    from bicubic_interpolation_model_tpu_torch.runtime import build
    from bicubic_interpolation_model_tpu_torch.serving import ModelUpscaler

    # the main path runs under PyTorch's default flags (cuDNN TF32 on): the
    # package keeps its f32 convs at full precision itself
    dev = torch.device("cuda")
    name_power = card()
    kind = torch.cuda.get_device_name(0)

    # 1. device
    emit({"phase": "device", "card": name_power, "kind": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    # 2. build
    rec = build.build(force=True)
    ptxas = {src: [ln.strip() for ln in log.splitlines()
                   if "registers" in ln or "spill" in ln]
             for src, log in rec["ptxas"].items()}
    build.library()
    emit({"phase": "build", "seconds": round(rec["seconds"], 3),
          "sources": [s.name for s in build.sources()], "ptxas": ptxas})

    # 3. kernel A vs its plain version
    a_err = 0
    for i, (h, w, c) in enumerate(GEOMETRIES):
        args = tail_case(h, w, c, dev, seed=1000 + i)
        got = pt.packed_tail_fused(*args, layout="planar")
        torch.cuda.synchronize()
        ref = pt.packed_tail_fused_reference(*args)
        g8, r8 = got.view(torch.uint8), ref.view(torch.uint8)
        mx, share = diff_u8(g8, r8)
        std = float(g8.float().std())
        bargs = (args[0].to(torch.bfloat16),) + args[1:]
        gb = pt.packed_tail_fused(*bargs, layout="planar")
        rb = pt.packed_tail_fused_reference(*bargs)
        mxb, shareb = diff_u8(gb.view(torch.uint8), rb.view(torch.uint8))
        ok = mx <= 1 and share < 1e-3 and std > 0 and mxb <= 2
        res = {"phase": "kernel_a", "geometry": [h, w, c], "f32_max": mx,
               "f32_share": share, "std": round(std, 3), "bf16_max": mxb,
               "bf16_share": shareb}
        if c == 4:
            oargs = (args[0], args[1].clone()) + args[2:]
            oargs[1][..., 3] = 255.0
            go = pt.packed_tail_fused(*oargs, layout="planar",
                                      opaque_alpha=True)
            ro = pt.packed_tail_fused_reference(*oargs, opaque_alpha=True)
            mxo, _ = diff_u8(go.view(torch.uint8), ro.view(torch.uint8))
            res["opaque_alpha_max"] = mxo
            ok = ok and mxo <= 1
        emit(res)
        if not ok:
            raise AssertionError(f"kernel A disagrees with its plain version: "
                                 f"{res}")
        a_err = max(a_err, mx)

    # 4. kernel B vs its plain version
    b_err = 0
    rng = np.random.default_rng(5)
    for shape in ((4, FRAME[0] * 4, FRAME[1]), (3, 37, 53)):
        planar = torch.from_numpy(
            rng.integers(0, 2 ** 32, shape, dtype=np.uint32)).to(dev)
        got = ilv.interleave_planar_u32(planar)
        ref = ilv.interleave_planar_u32_reference(planar).contiguous()
        mx, _ = diff_u8(got.view(torch.uint8), ref.view(torch.uint8))
        b_err = max(b_err, mx)
        emit({"phase": "kernel_b", "shape": list(shape), "max_abs_err": mx})
        if mx != 0:
            raise AssertionError(f"kernel B differs from its plain version "
                                 f"at {shape}")

    # 5. main path: ModelUpscaler on the committed checkpoint
    up = ModelUpscaler(str(ROOT / "model" / "wp-1e-3-120"))
    rng = np.random.default_rng(20)
    frames = rng.integers(0, 256, (10,) + FRAME + (4,), dtype=np.uint8)
    frames[..., 3] = 255
    pt.packed_tail_fused.launches = 0
    ilv.interleave_planar_u32.launches = 0
    outs = [up(f) for f in frames[:4]]
    outs += list(up.stream(iter(frames[4:8])))
    outs_b = up.batch(frames[8:10])
    torch.cuda.synchronize()
    launches = {"packed_tail_fused": pt.packed_tail_fused.launches,
                "interleave_planar_u32": ilv.interleave_planar_u32.launches}
    emit({"phase": "main_path", "requests": 8, "batch": 2,
          "launches": launches})
    if launches != {"packed_tail_fused": 9, "interleave_planar_u32": 8}:
        raise AssertionError(f"main path did not run the kernels as "
                             f"expected: {launches}")
    hw = (FRAME[0] * 4, FRAME[1] * 4, 4)
    for o in outs + list(outs_b):
        if o.shape != hw or o.dtype != np.uint8:
            raise AssertionError(f"bad output {o.shape} {o.dtype}")
    h32 = up(frames[0], fetch=False)
    hwc = super_resolve(up.model, up.params, frames[0], convention="train")
    if h32.dtype != torch.uint32 or not torch.equal(
            h32.contiguous().view(torch.uint8).reshape(hw), hwc):
        raise AssertionError("hwc32 bytes differ from hwc bytes")
    worst = (0, 0.0)
    for i, o in enumerate(outs + list(outs_b)):
        g = super_resolve(up.model, up.params, frames[i], convention="train",
                          tail="graph")
        mx, share = diff_u8(torch.as_tensor(o).to(dev), g)
        worst = max(worst, (mx, share))
        if mx > 1 or share >= 1e-3:
            raise AssertionError(f"frame {i}: {mx} LSB / {share} vs graph")
    exact = super_resolve(up.model, up.params, frames[0], convention="train",
                          exact=True)
    ex_mx, ex_share = diff_u8(torch.as_tensor(outs[0]).to(dev), exact)
    if ex_mx > 2:
        raise AssertionError(f"packed vs exact: {ex_mx} LSB")
    emit({"phase": "main_path_check", "vs_graph_max": worst[0],
          "vs_graph_share": worst[1], "vs_exact_max": ex_mx,
          "vs_exact_share": ex_share, "hwc32_equals_hwc": True,
          "std": round(float(np.asarray(outs[0], np.float32).std()), 3)})

    up_a = ModelUpscaler(str(ROOT / "model" / "wp-adaptive-1e-3-120"))
    oa = up_a(frames[0])
    ga = super_resolve(up_a.model, up_a.params, frames[0],
                       convention="train", tail="graph")
    mx, share = diff_u8(torch.as_tensor(oa).to(dev), ga)
    emit({"phase": "main_path_adaptive", "vs_graph_max": mx,
          "vs_graph_share": share})
    if mx > 1 or share >= 1e-3 or float(np.asarray(oa, np.float32).std()) == 0:
        raise AssertionError("wp-adaptive-1e-3-120 disagrees with its graph")

    # 6. times at the main path's shapes
    # inputs rotate over 4 (A) or 8 (B) copies, 91 MB each way, so every
    # call reads from HBM and not from the 50 MB L2
    h, w = FRAME
    args = tail_case(h, w, 4, dev, seed=7)
    a_in = [(args[0].clone(), args[1].clone()) for _ in range(4)]
    run_a = rotating(lambda y, lr: pt.packed_tail_fused(
        y, lr, *args[2:], layout="planar"), a_in)
    run_a_plain = rotating(lambda y, lr: pt.packed_tail_fused_reference(
        y, lr, *args[2:]), a_in)
    planar = pt.packed_tail_fused(*args, layout="planar")[0]
    b_in = [(planar.clone(),) for _ in range(8)]
    run_b = rotating(ilv.interleave_planar_u32, b_in)
    run_b_plain = rotating(
        lambda t: ilv.interleave_planar_u32_reference(t).contiguous(), b_in)
    run_b_lib = rotating(lambda t: t.permute(1, 2, 0).contiguous(), b_in)
    # per-call times with the wrapper's host cost: CUDA events around
    # back-to-back calls; kernel times: device time per launch from the
    # profiler (the per-call time where the trace holds no device events)
    a_call = time_ms(run_a, iters=10)
    a_plain_call = time_ms(run_a_plain, runs=5)
    b_call = time_ms(run_b, iters=50)
    b_plain_call = time_ms(run_b_plain, iters=50)
    b_lib_call = time_ms(run_b_lib, iters=50)
    a_ms = device_ms(run_a) or a_call
    a_plain = device_ms(run_a_plain, n=5) or a_plain_call
    b_ms = device_ms(run_b) or b_call
    b_plain = device_ms(run_b_plain) or b_plain_call
    b_lib = device_ms(run_b_lib) or b_lib_call
    lr_dev = torch.as_tensor(frames[0]).to(dev)
    call_dev = time_ms(lambda: up(lr_dev, fetch=False), iters=10)
    call_host = time_ms(lambda: up(frames[0]))
    a_bound, a_by, a_bytes, a_flops = tail_bound(h, w, 4, 4)
    b_bytes = 2 * planar.numel() * 4
    b_bound = b_bytes / HBM_BYTES_PER_S * 1e3
    emit({"phase": "times", "card": name_power, "frame": [h, w, 4],
          "packed_tail_fused_ms": a_ms,
          "packed_tail_fused_plain_ms_no_yardstick": a_plain,
          "interleave_planar_u32_ms": b_ms,
          "interleave_planar_u32_plain_ms_no_yardstick": b_plain,
          "interleave_permute_contiguous_ms": b_lib,
          "per_call_ms_with_host_launch": {
              "packed_tail_fused": a_call, "interleave_planar_u32": b_call,
              "interleave_planar_u32_plain": b_plain_call,
              "packed_tail_fused_plain": a_plain_call,
              "interleave_permute_contiguous": b_lib_call},
          "model_upscaler_call_device_ms": call_dev,
          "model_upscaler_call_fetch_ms": call_host,
          "packed_tail_bytes": a_bytes, "packed_tail_flops": a_flops,
          "packed_tail_bound_ms": a_bound,
          "interleave_bytes": b_bytes, "interleave_bound_ms": b_bound})

    emit({"phase": "profile", "card": name_power,
          **profile_served_frames(up, frames[0], n=5)})

    # 7. kernels line, then the card, then the result
    emit({"kernels": [
        {"name": "packed_tail_fused", "route": "cuda",
         "source": "bicubic_interpolation_model_tpu_torch/csrc/packed_tail.cu",
         "replaces": "bicubic_interpolation_model_tpu/ops/"
                     "pallas_packed_tail.py:145",
         "launches": launches["packed_tail_fused"], "max_abs_err": a_err,
         "ms": a_ms, "plain_ms": a_plain, "bound_ms": a_bound,
         "bound_by": a_by, "library_ms": None},
        {"name": "interleave_planar_u32", "route": "cuda",
         "source": "bicubic_interpolation_model_tpu_torch/csrc/interleave.cu",
         "replaces": "bicubic_interpolation_model_tpu/ops/"
                     "pallas_interleave.py:38",
         "launches": launches["interleave_planar_u32"], "max_abs_err": b_err,
         "ms": b_ms, "plain_ms": b_plain, "bound_ms": b_bound,
         "bound_by": "bytes", "library_ms": b_lib}]})
    print(name_power, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    t0 = time.perf_counter()
    rc = main()
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s",
          file=sys.stderr, flush=True)
    sys.exit(rc)
