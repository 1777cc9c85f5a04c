"""The benchmark's work counts, trace reader, data-driven lookup, control
and planted faults, on the CPU. Run from the checkout's root:
``python -m pytest benchmark/tests``."""

from __future__ import annotations

import hashlib
import json
import pathlib
import shutil
import sys
import time

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import control, drive, harness, spec, tracing, work  # noqa

SMALL = {"frame": [12, 20, 4], "pool": 5, "warmup_frames": 4, "sample": 16}
#: the group a cell's stream makes at its own frame size ("auto"), forced
#: at the tests' small size, where "auto" would group far more
GROUP = {"wp_540p_stream": 1}
CELLS = ("wp_540p_stream", "bicubic_1080p_call", "wp_div2k_call")


# -- work counts against the figures on record -------------------------

def test_tail_bound_of_kernel_a_at_348x510():
    ms, by, nbytes, _ = work.tail_bound(348, 510, 4)
    assert by == "operations"
    assert round(nbytes / 1e6, 1) == 36.9
    assert round(ms, 4) == 0.0969        # 15.99 GFLOP of 3xTF32 products


def test_resize_bound_of_kernel_c_at_1080p_4x():
    ms, by, nbytes, _ = work.resize_bound(1, 1080, 1920, 4, 4320, 7680, 4)
    assert by == "bytes"
    assert round(nbytes / 1e6, 1) == 141.0
    assert round(ms, 4) == 0.0421


def test_model_step_flops_per_lr_pixel():
    assert work.weight_predictor_flops(1, 1) == 113664
    assert work.weight_predictor_flops(540, 960) == 113664 * 540 * 960


# -- the trace reader on a synthetic event list ------------------------

def _x(cat, name, ts, dur, corr=None, tid=1):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


EVENTS = [
    _x("user_annotation", "window", 100, 100),
    _x("gpu_user_annotation", "window", 100, 100),
    _x("user_annotation", "stream.next", 100, 50),
    _x("user_annotation", "next_frame", 105, 5),
    _x("user_annotation", "host_result", 150, 50),
    _x("cuda_runtime", "cudaLaunchKernel", 110, 5, corr=1),
    # the driver call inside the runtime launch is the same launch
    _x("cuda_driver", "cuLaunchKernel", 111, 2, corr=2),
    _x("cuda_driver", "cuLaunchKernelEx", 120, 2, corr=3),
    _x("cuda_runtime", "cudaMemcpyAsync", 121, 2, corr=4),
    _x("kernel", "void (anonymous namespace)::resize_plan_kernel<4, true>",
       120, 20, corr=1),
    _x("kernel", "sm80_xmma_fprop_implicit_gemm_f32f32", 130, 20, corr=3),
    _x("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 160, 10, corr=4),
    _x("kernel", "void some_unknown_kernel", 175, 5, corr=5),
    _x("kernel", "before the window", 50, 20, corr=6),
]


def _trace(events=EVENTS):
    return tracing.Trace(events, tracing.load_layers(
        ROOT / "benchmark" / "layers"))


def test_trace_busy_is_a_union_inside_the_window():
    t = _trace()
    assert t.window_s == pytest.approx(100e-6)
    # [120, 150) kernels overlapping, [160, 170) copy, [175, 180) kernel
    assert t.busy_s() == pytest.approx(45e-6)
    assert t.copy_s() == pytest.approx(10e-6)


def test_trace_assigns_kernels_to_layers_by_name():
    t = _trace()
    assert t.kernel_s("convs") == pytest.approx(20e-6)
    assert t.kernel_s("resize") == pytest.approx(20e-6)
    assert t.kernel_s() == pytest.approx(45e-6)
    assert t.kernel_s(exclude=("convs",)) == pytest.approx(25e-6)
    assert t.unassigned() == ["void some_unknown_kernel"]
    assert t.kernel_count("resize_plan_kernel") == 1


def test_trace_counts_launches_once_and_finds_lost_kernels():
    t = _trace()
    assert sorted(t.launches) == [1, 3]
    assert t.complete()
    lost = [e for e in EVENTS if (e.get("args") or {}).get("correlation")
            != 3 or e["cat"] != "kernel"]
    t = _trace(lost)
    assert t.lost_launches() == 1 and not t.complete()


def test_trace_breakdown_labels_idle_gaps_by_the_host_span():
    b = _trace().breakdown()
    ops = dict(b["device_ops"])
    assert ops["Memcpy DtoH (Device -> Pinned)"] == pytest.approx(10e-6)
    gaps = dict(b["idle_gaps"])
    # [100, 120) in next_frame (middle 110), [150, 160) and [170, 175)
    # and [180, 200) in host_result
    assert gaps == pytest.approx({"next_frame": 20e-6,
                                  "host_result": 35e-6})
    assert len(b["device_ops"]) <= tracing.BREAKDOWN_ENTRIES


def test_trace_needs_one_window():
    with pytest.raises(ValueError):
        _trace(EVENTS[2:])


# -- the sample and the window -----------------------------------------

def test_sample_is_uniform_and_seeded():
    picks = []
    for seed in (1, 2):
        s = drive.Sample(4, seed)
        for k in range(1000):
            s.offer(k, np.full(1, k % 256, np.uint8))
        picks.append(s.pool_ids)
    assert picks[0] != picks[1]
    s = drive.Sample(4, 1)
    for k in range(1000):
        s.offer(k, np.full(1, k % 256, np.uint8))
    assert s.pool_ids == picks[0]
    assert max(picks[0]) > 250           # not only the first results


def test_percentile_is_nearest_rank():
    v = list(range(1, 101))
    assert harness.percentile(v, 0.95) == 95
    assert harness.percentile(v, 0.50) == 50
    assert harness.percentile([3.0], 0.95) == 3.0


# -- data-driven: new files are found by name --------------------------

def _digests(root: pathlib.Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_a_new_cell_mix_and_metric_need_only_new_files(tmp_path,
                                                        monkeypatch):
    bench_dir = tmp_path / "benchmark"
    shutil.copytree(ROOT / "benchmark", bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = _digests(bench_dir)

    (bench_dir / "traffic" / "rgba_tiny_call.json").write_text(json.dumps(
        {"frame": [9, 13, 4], "pool": 3, "entry": "call",
         "warmup_frames": 2, "sample": 2, "trace_seconds": 1}))
    (bench_dir / "metrics" / "frame_ms_max.call.py").write_text(
        '"""Slowest call of the window."""\n\n\ndef read(ctx):\n'
        '    return max(ctx.window.times) * 1e3\n')
    bench["workloads"].append(
        {"name": "bicubic_tiny_call", "config": "bicubic_x4",
         "traffic": "rgba_tiny_call", "chips": 1, "why": "test"})
    bench["per_layer"].append(
        {"name": "frame_ms_max.call", "unit": "ms", "better": "lower",
         "source": "host_clock", "layer": "serving",
         "moves": "frame_ms_p95", "workloads": ["bicubic_tiny_call"]})
    for m in bench["end_to_end"]:
        if m["name"] in ("frame_ms_p50", "frame_ms_p95"):
            m["workloads"].append("bicubic_tiny_call")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    here = bench_dir
    monkeypatch.setattr(spec, "benchmark",
                        lambda root=tmp_path: json.loads(
                            (tmp_path / "BENCHMARK.json").read_text()))
    for name in ("config", "traffic", "reader"):
        real = getattr(spec, name)
        monkeypatch.setattr(spec, name,
                            lambda n, _real=real: _real(n, here))
    out = harness.run_cell("bicubic_tiny_call", 3, 0.2, False,
                           time.perf_counter(), device="cpu",
                           log=lambda s: None)
    assert out["correct"] and out["attempted"] >= 1
    assert set(out["metrics"]) == {"frame_ms_p50", "frame_ms_p95",
                                   "setup_s"}
    traced = [m["name"] for m in spec.metrics_of(spec.benchmark(),
                                                 "bicubic_tiny_call", True)]
    assert traced == ["frame_ms_max.call"]
    ctx = harness.Context({}, {}, {}, 0.0, drive.Window(
        1.0, 2, 2, 0, [0.001, 0.003]))
    assert spec.reader("frame_ms_max.call")(ctx) == pytest.approx(3.0)
    after = _digests(bench_dir)
    assert {k: v for k, v in after.items() if k in before} == before


def test_every_entry_of_benchmark_json_has_its_files():
    bench = spec.benchmark()
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert spec.config(c["name"])["name"] == c["name"]
    for w in bench["workloads"]:
        spec.traffic(w["traffic"])
        spec.config(w["config"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.reader(m["name"]))
    layers = {s["layer"] for s in tracing.load_layers(
        ROOT / "benchmark" / "layers").values()}
    per_layer_names = {m["layer"] for m in bench["per_layer"]}
    assert per_layer_names - {"device", "serving"} <= layers


# -- the control and the planted faults --------------------------------

@pytest.mark.parametrize("cell", ["wp_div2k_call", "bicubic_1080p_call"])
def test_control_in_tf32_fails_the_check(cell):
    rows = control.control_readings(cell, [1, 2, 3], device="cpu",
                                    mix_override={**SMALL, "sample": 4})
    for row in rows:
        assert row["control_mismatch_share"] > row["limit"]


def _run(cell, seed=11):
    mix = {**SMALL, "microbatch": GROUP[cell]} if cell in GROUP else SMALL
    return harness.run_cell(cell, seed, 0.3, False, time.perf_counter(),
                            device="cpu", mix_override=mix,
                            log=lambda s: None)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_cpu_run_is_correct(cell):
    out = _run(cell)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 1


def _fault_altered(monkeypatch, serving):
    """Every result has bytes changed where it is produced (the fetch)."""
    real = serving._start_fetch

    def start_fetch(out, side=None):
        finish = real(out, side)

        def altered():
            host = np.array(finish(), order="C")
            flat = host.reshape(-1)
            flat[::16] += 1
            return host
        return altered
    monkeypatch.setattr(serving, "_start_fetch", start_fetch)


def _fault_stale(monkeypatch, serving):
    """Each result is the previous one again: state left unchanged."""
    real = serving._start_fetch
    last = []

    def start_fetch(out, side=None):
        finish = real(out, side)

        def stale():
            host = np.array(finish())
            prev = last[0] if last and last[0].shape == host.shape else host
            last[:] = [host]
            return prev
        return stale
    monkeypatch.setattr(serving, "_start_fetch", start_fetch)


# "half of the batch left out" needs a cell that groups frames, and no
# cell does at its own size (wp_540p_stream serves one frame a launch);
# no cell spans chips, so no exchange can be left out
FAULTS = {"altered": (_fault_altered, CELLS),
          "stale": (_fault_stale, CELLS)}


@pytest.mark.parametrize("fault,cell", [(f, c) for f, (_, cells)
                                        in FAULTS.items() for c in cells])
def test_planted_fault_makes_the_run_not_correct(fault, cell, monkeypatch):
    from bicubic_interpolation_model_tpu_torch import serving
    FAULTS[fault][0](monkeypatch, serving)
    out = _run(cell)
    assert not out["correct"], out["checks"]


# -- on the card -------------------------------------------------------

@pytest.fixture()
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cell's path runs the port's "
                    "CUDA kernels, which have no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(card, cell):
    import subprocess
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         "2147483700", "--seconds", "2", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["wp_540p_stream", "bicubic_1080p_call"])
def test_control_fails_on_the_card_at_the_cells_size(card, cell):
    for row in control.control_readings(cell, [1, 2, 3]):
        assert row["control_mismatch_share"] > row["limit"]
