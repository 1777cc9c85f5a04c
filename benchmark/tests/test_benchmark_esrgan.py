"""The cell ``esrgan_div2k_call`` (the published ESRGAN generator,
configuration ``esrgan-rrdbnet-x4``) on the CPU at a small RGB frame: a
sound run is correct, the TF32 control and the planted faults are not;
its work counts and per-layer readers; and one card run. Run from the
checkout's root: ``python -m pytest benchmark/tests``."""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import control, drive, harness, spec, tracing  # noqa: E402
from benchmark import work_esrgan  # noqa: E402
from test_benchmark_harness import FAULTS  # noqa: E402

CELL = "esrgan_div2k_call"
SMALL = {"frame": [12, 20, 3], "pool": 3, "warmup_frames": 2, "sample": 4}


def _run(seed=11):
    return harness.run_cell(CELL, seed, 0.3, False, time.perf_counter(),
                            device="cpu", mix_override=SMALL,
                            log=lambda s: None)


def test_sound_cpu_run_is_correct():
    out = _run(2 ** 31 + 17)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 1
    assert set(out["metrics"]) == {"frame_ms_p50", "frame_ms_p95",
                                   "setup_s"}


def test_control_in_tf32_fails_the_check():
    rows = control.control_readings(CELL, [1, 2, 3], device="cpu",
                                    mix_override=SMALL)
    for row in rows:
        assert row["control_mismatch_share"] > row["limit"], row


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_fault_makes_the_run_not_correct(fault, monkeypatch):
    from bicubic_interpolation_model_tpu_torch import serving
    FAULTS[fault][0](monkeypatch, serving)
    out = _run()
    assert not out["correct"], out["checks"]


# -- work counts ---------------------------------------------------------

def test_flops_per_lr_pixel_and_at_the_cell_frame():
    assert work_esrgan.flops(1, 1) == 35_853_696
    assert round(work_esrgan.flops(339, 510) / 1e12, 3) == 6.199
    body = 2 * 9 * (64 * 32 + 96 * 32 + 128 * 32 + 160 * 32 + 192 * 64)
    assert body * 69 / work_esrgan.flops(1, 1) == pytest.approx(0.9223,
                                                                abs=1e-4)


def test_concat_and_conv_bytes_and_bound():
    assert work_esrgan.concat_bytes(1, 1) == 4608 * 69
    ms, by = work_esrgan.conv_bound(339, 510)
    assert by == "operations"
    assert ms == pytest.approx(6.1988e12 / 165e12 * 1e3, rel=1e-4)
    # no dense block: conv_first, conv_body at 1 pixel, conv_up1 at 4,
    # conv_up2, conv_hr, conv_last at 16; inputs, outputs and weights once
    assert work_esrgan.conv_bytes(1, 1, n_blocks=0) == 4 * (
        (67 + 9 * 3 * 64 + 64) + (128 + 9 * 64 * 64 + 64)
        + (4 * 128 + 36928) + 2 * (16 * 128 + 36928)
        + (16 * 67 + 9 * 64 * 3 + 3))
    # a dense block's five convs: 832 channels in and out a pixel
    per_block = work_esrgan.conv_bytes(1000, 1000, n_blocks=1) \
        - work_esrgan.conv_bytes(1000, 1000, n_blocks=0)
    assert per_block == 3 * 4 * (832 * 10 ** 6 + 9 * 26624 + 192)


# -- the per-layer readers -------------------------------------------------

def _x(cat, name, ts, dur, corr):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": 1, "args": {"correlation": corr}}


EVENTS = [
    {"ph": "X", "cat": "user_annotation", "name": "window", "ts": 0,
     "dur": 1000, "tid": 1},
    _x("kernel", "sm80_xmma_fprop_implicit_gemm_f32f32_f32f32", 10, 400, 1),
    _x("kernel", "void cudnn::engines_precompiled::nhwcToNchwKernel<float>",
       410, 100, 2),
    _x("kernel", "void at::native::CatArrayBatchedCopy<float>", 520, 60, 3),
    _x("kernel", "void at::native::elementwise_kernel<128, 2>", 580, 30, 4),
    _x("kernel", "void at::native::upsample_nearest2d_out_frame<float>",
       610, 10, 5),
    _x("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 620, 300, 6),
]


def _ctx(trace=True, frames=2):
    bench = spec.benchmark()
    cell = spec.cell(bench, CELL)
    config, mix = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    tr = tracing.Trace(EVENTS, tracing.load_layers(
        ROOT / "benchmark" / "layers")) if trace else None
    win = drive.Window(0.5, frames, frames, 0, [0.25] * frames)
    return harness.Context(cell, config, mix, 0.0, win, tr)


def test_readers_of_the_cell_read_the_trace():
    read = lambda name, ctx: spec.reader(name)(ctx)
    ctx = _ctx()
    assert read("glue_ms.esrgan_call", ctx) == pytest.approx(0.1 / 2)
    conv_ms = 0.5 / 2
    bound = work_esrgan.conv_bound(339, 510)[0]
    assert read("conv_roofline.esrgan_call", ctx) == pytest.approx(
        100 * bound / conv_ms)
    assert read("model_mfu.esrgan_call", ctx) == pytest.approx(
        100 * 2 * work_esrgan.flops(339, 510) / (0.5 * 165e12))
    untraced = _ctx(trace=False)
    assert read("glue_ms.esrgan_call", untraced) is None
    assert read("conv_roofline.esrgan_call", untraced) is None
    traced = [m["name"] for m in spec.metrics_of(spec.benchmark(), CELL,
                                                 True)]
    assert traced == ["device_idle_pct.call", "model_mfu.esrgan_call",
                      "conv_roofline.esrgan_call", "glue_ms.esrgan_call"]


# -- on the card -------------------------------------------------------

@pytest.fixture()
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cell runs at 339x510 on the "
                    "card")


@pytest.mark.cuda
def test_cell_runs_correct_on_the_card(card):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELL, "--seed",
         "2147483700", "--seconds", "2", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["failed"] == 0
    assert line["device"]["platform"] == "gpu"
