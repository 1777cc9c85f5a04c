"""The port's bench (bicubic_interpolation_model_tpu_torch/bench/{harness,suite}.py
and bench_torch.py) against the JAX package's bench and bench.py, on the CPU.

Tolerances: the harness's CSV schema and warmup count, ``_make_input`` and
``chained_slope`` are equal; ``check_parity`` is ±1 u8 and equal to the
JAX value for the plain graph names (``gather``, ``matmul``, ``phase``,
``auto``), while for the kernels' names both are ≤1 (the JAX Pallas
kernels run in interpret mode, the port's names their plain versions);
bench_torch.py's last line has exactly bench.py's keys and values with
``"backend": "cuda"``. The on-device timings need the card
(tests/test_torch_kernels.py)."""

import importlib.util
import json
import pathlib

import numpy as np
import pytest
import torch

import bench_torch
from bicubic_interpolation_model_tpu.bench import suite as jsuite
from bicubic_interpolation_model_tpu_torch.bench import harness, suite

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("runs,warmup", [(2, 1), (3, 0), (1, 2)])
def test_harness_csv_schema_and_warmup_count(tmp_path, runs, warmup):
    calls = []
    res = harness.performance_test(lambda: calls.append(1),
                                   test_item="unit", runs=runs,
                                   warmup=warmup, out_dir=tmp_path)
    assert len(calls) == warmup + runs
    csv = (tmp_path / "unit" / "unit_performance.csv").read_text()
    lines = csv.splitlines()
    assert lines[0] == ("Run,Timestamp,Execution Time (ms),CPU Time (ms),"
                        "Memory (MB)")
    assert [ln.split(",")[0] for ln in lines[1:]] == [
        str(i + 1) for i in range(runs)]
    assert len(res.wall_ms) == len(res.cpu_ms) == len(res.rss_mb) == runs
    assert res.best_ms == min(res.wall_ms) and res.rss_mb[0] > 0


def test_harness_fences_nested_results_and_writes_no_csv_without_dir(
        tmp_path, monkeypatch):
    """``_block`` waits on the device of every CUDA tensor in a returned
    structure (none here: CPU tensors and host values pass through)."""
    waited = []
    monkeypatch.setattr(torch.cuda, "synchronize", waited.append)
    out = {"a": [torch.zeros(2), (torch.ones(1), 3)], "b": np.zeros(1)}
    assert harness._block(out) is out and waited == []
    fake = torch.empty(1, device="meta")
    assert harness._cuda_devices([fake, {"x": torch.zeros(1)}], set()) == set()
    harness.performance_test(lambda: out, test_item="none", runs=1,
                             warmup=0, out_dir=None)
    assert not any(tmp_path.iterdir())


@pytest.mark.parametrize("h,w,c,seed", [(24, 16, 4, 0), (7, 9, 3, 5),
                                        (1080, 1920, 4, 0), (5, 4, 1, 2)])
def test_make_input_byte_equal_to_jax(h, w, c, seed):
    got = suite._make_input(h, w, c, seed)
    want = jsuite._make_input(h, w, c, seed)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


@pytest.mark.parametrize("impl,scale", [
    (impl, s) for impl in ("gather", "matmul", "phase", "auto")
    for s in (2, 4, 2.5)] + [
    (impl, s) for impl in ("pallas_mxu", "pallas_phase",
                           "pallas_phase_planar", "pallas") for s in (2, 3)]
    + [("pallas_mxu", 2.5)])
def test_check_parity_matches_jax(impl, scale):
    got = suite.check_parity(scale=scale, impl=impl, h=24, w=16,
                             device="cpu")
    want = jsuite.check_parity(scale=scale, impl=impl, h=24, w=16)
    assert got <= 1 and want <= 1
    if not impl.startswith("pallas"):
        assert got == want


def test_check_parity_row_stride_samples_the_same_rows():
    """A row stride compares the oracle's rows against the device's same
    rows: at stride 3 it equals the exhaustive value on a frame small
    enough for both."""
    full = suite.check_parity(scale=4, impl="pallas_phase_planar", h=20,
                              w=12, device="cpu")
    strided = suite.check_parity(scale=4, impl="pallas_phase_planar", h=20,
                                 w=12, row_stride=3, device="cpu")
    assert strided <= full <= 1
    assert suite.check_parity(scale=4, impl="pallas_mxu", h=20, w=12,
                              row_stride=7, device="cpu") <= 1


def test_headline_cpu_smoke():
    best, results = suite.headline(impls=("matmul",), runs=1, h=24, w=16,
                                   scale=2, device="cpu")
    assert best is not None and best is results[0]
    assert best["impl"] == "matmul" and best["max_u8_delta"] <= 1
    assert best["gpix_per_s"] > 0 and best["parity_geometry"] == "96x64"
    assert set(best) == {"item", "best_ms", "mean_ms", "out_mpix",
                         "gpix_per_s", "impl", "max_u8_delta",
                         "parity_geometry"}
    json.dumps(best)


def test_headline_records_an_impl_that_raises():
    best, results = suite.headline(impls=("matmul", "no_such_impl"), runs=1,
                                   h=24, w=16, scale=2, device="cpu")
    assert best["impl"] == "matmul"
    assert results[1]["impl"] == "no_such_impl"
    assert results[1]["error"].startswith("ValueError")
    assert bench_torch.failures(results) == [results[1]]


def test_on_device_timings_refuse_the_cpu():
    with pytest.raises(ValueError, match="card"):
        suite.chained_bench(lambda x: x, torch.zeros(4, dtype=torch.uint8))
    with pytest.raises(ValueError, match="card"):
        suite.bench_program_output(lambda x: x, torch.zeros(4))
    with pytest.raises(ValueError, match="card"):
        suite.bench_resize_ondevice(8, 8, 2, device="cpu")


@pytest.mark.parametrize("fixed,per,k_lo,k_hi,min_delta", [
    (0.01, 0.002, 3, 15, 0.25), (0.5, 1e-4, 5, 50, 0.25),
    (0.0, 0.3, 2, 6, 0.25), (0.02, 1e-5, 3, 15, 0.01)])
def test_chained_slope_equals_jax(fixed, per, k_lo, k_hi, min_delta):
    seen, jseen = [], []

    def timed(k, log):
        log.append(k)
        return fixed + per * k

    got = suite.chained_slope(lambda k: timed(k, seen), k_lo, k_hi,
                              min_delta)
    want = jsuite.chained_slope(lambda k: timed(k, jseen), k_lo, k_hi,
                                min_delta)
    assert got == want and seen == jseen
    assert got == pytest.approx(per, rel=1e-6)


def test_rotated_inputs_exceed_the_l2_and_differ():
    img = torch.from_numpy(suite._make_input(1080, 1920))
    inputs = suite._rotated(img)
    assert len(inputs) * img.numel() >= 2 * suite.L2_BYTES
    assert torch.equal(inputs[0], img)
    assert not torch.equal(inputs[1], inputs[2])
    assert len(suite._rotated(torch.zeros(4, dtype=torch.uint8))) == 64


def _bench_py_line(monkeypatch, capsys, best, results):
    spec = importlib.util.spec_from_file_location("bench", ROOT / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(jsuite, "headline",
                        lambda impls, runs: (best, results))
    assert mod.main() == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("fastest", ["pallas_mxu", "pallas_phase",
                                     "pallas_phase_planar"])
def test_bench_torch_line_has_bench_py_keys(monkeypatch, capsys, fastest):
    results = [
        {"impl": "pallas_mxu", "gpix_per_s": 250.123456, "max_u8_delta": 1,
         "parity_geometry": "1080x1920", "layout": "delivered_hwc"},
        {"impl": "pallas_phase", "gpix_per_s": 240.5, "max_u8_delta": 1,
         "parity_geometry": "1080x1920"},
        {"impl": "pallas_phase_planar", "gpix_per_s": 230.25,
         "max_u8_delta": 0, "parity_geometry": "1080x1920",
         "layout": "planar_phase"}]
    best = next(r for r in results if r["impl"] == fastest)
    best["gpix_per_s"] = 300.0
    assert suite.best_passing(results) is best
    want = _bench_py_line(monkeypatch, capsys, best, results)
    got = bench_torch.last_line(best, results)
    assert set(got) == set(want)
    assert got == dict(want, backend="cuda")
    assert json.loads(json.dumps(got)) == got
