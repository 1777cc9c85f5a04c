"""The port's measurement scripts (``bench/configs.py``, ``bench/methods.py``
and ``scripts/torch_{bench_configs,latency_curve,method_throughput}.py``)
against the JAX package's scripts and Pallas kernels, on the CPU at small
sizes. Inputs come from numpy seeds; the JAX Pallas kernels run in
interpret mode. Tolerance: ≤1 u8 (the kernels' contract with the oracle;
the JAX and port kernels are expected bit-equal here).

The JAX scripts are no package: their module constants are loaded by path
(``importlib``) and the values they inline in ``main`` are read from their
source with ``ast``. The JAX rows' keys are those of the TPU records the
JAX scripts wrote (``results/{bench_configs,latency_curve,
method_throughput}.json``); the records' numbers are not read.
"""

import ast
import importlib.util
import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bicubic_interpolation_model_tpu.core import oracle as jo
from bicubic_interpolation_model_tpu.ops import pallas_mxu as jmx
from bicubic_interpolation_model_tpu.ops import pallas_phase as jph
from bicubic_interpolation_model_tpu.serving import ModelUpscaler as \
    JModelUpscaler
from bicubic_interpolation_model_tpu.serving import Upscaler as JUpscaler
from bicubic_interpolation_model_tpu_torch import serving
from bicubic_interpolation_model_tpu_torch.bench import configs, methods, suite
from bicubic_interpolation_model_tpu_torch.serving import (ModelUpscaler,
                                                            Upscaler)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
BUCKETS = ((2, 3), (3, 2), (4, 2))          # 3 + 2 + 2 frames
STREAM_SIZES = ((24, 40), (22, 37), (26, 35))


def _module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _delta(a, b) -> int:
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return int(np.abs(a.astype(np.int64) - b.astype(np.int64)).max())


def _main_literals(name):
    """The ``ast`` nodes of ``scripts/<name>.py``'s ``main``."""
    tree = ast.parse((ROOT / "scripts" / f"{name}.py").read_text())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    return list(ast.walk(main))


def _for_iter(nodes, *names):
    """The literal a ``for <names> in <literal>`` loop of ``nodes`` walks
    (the targets' names flattened in order)."""
    def flat(t):
        if isinstance(t, ast.Name):
            return [t.id]
        return [x for e in t.elts for x in flat(e)]
    for n in nodes:
        if isinstance(n, ast.For) and flat(n.target) == list(names):
            it = n.iter
            if isinstance(it, ast.Call):          # {...}.items()
                it = it.func.value
            return ast.literal_eval(it)
    raise AssertionError(f"no loop over {names}")


def _assigned(nodes, *names):
    for n in nodes:
        if isinstance(n, ast.Assign) and len(n.targets) == 1:
            t = n.targets[0]
            got = ([t.id] if isinstance(t, ast.Name)
                   else [e.id for e in getattr(t, "elts", [])
                         if isinstance(e, ast.Name)])
            if got == list(names):
                return ast.literal_eval(n.value)
    raise AssertionError(f"no assignment to {names}")


# ---- (a) config 3: the mixed batch, one launch of D per bucket ----------


@pytest.fixture(scope="module")
def mixed():
    batch = np.random.default_rng(3).integers(0, 256, (7, 24, 40, 4),
                                              dtype=np.uint8)
    outs = configs.mixed_batch_fn(BUCKETS, {})(torch.from_numpy(batch))
    return batch, outs


@pytest.mark.parametrize("bucket", range(len(BUCKETS)))
def test_mixed_batch_bucket_equals_jax_phase_kernel(mixed, bucket):
    batch, outs = mixed
    o = sum(n for _, n in BUCKETS[:bucket])
    s, n = BUCKETS[bucket]
    want = np.asarray(jph.resize_phase_pallas(batch[o:o + n], s, "bicubic",
                                              interpret=True))
    assert _delta(outs[bucket].numpy(), want) <= 1


def test_mixed_batch_row_holds_its_frames_to_the_oracle():
    row, pending = configs.run_mixed_batch(geo=configs.SMALL, dev=CPU)
    configs.hold(pending)
    assert row["max_u8_delta"] <= 1
    assert len(pending[0][1]) == configs.SMALL.mixed_batch[0]
    assert row["expected_launches"]["resize_phase"] == len(
        configs.SMALL.mixed_buckets)
    assert row["seconds"] is None and row["out_mpix"] > 0


# ---- (b) config 6: frames of several sizes through D --------------------


@pytest.fixture(scope="module")
def bucket_program():
    """The JAX c6 row's program on the three sizes: per-size plan arrays
    scattered into one bucket's extents (``_phase_plan_arrays``,
    ``_interleave_wrow``), zero-padded frames, ``_phase_call`` in interpret
    mode, at the smallest step (8 rows), wstep (32 RGBA pixels: 128 lanes)
    and bucket (8) it takes; each output cropped to its real extents."""
    geo = configs.Geometry({}, (), (), STREAM_SIZES, 0, ())
    frames = configs.mixed_size_frames(geo)
    s, c, bucket, step, wstep = configs.MIXED_SIZE_SCALE, 4, 8, 8, 32
    hb = max(-(-h // bucket) * bucket for h, _ in STREAM_SIZES)
    wb = max(-(-w // bucket) * bucket for _, w in STREAM_SIZES)
    n_i, n_j = -(-hb // step), -(-wb // wstep)
    outs = []
    for f, (h, w) in zip(frames, STREAM_SIZES):
        wrow, wcol, taps, left = jph._phase_plan_arrays(
            "bicubic", h, w, c, s, -0.5, 3, step, wstep, n_i, n_j)
        padded = np.zeros((1, hb, wb, c), np.uint8)
        padded[0, :h, :w] = f
        y = jph._phase_call_jit(
            jnp.asarray(padded), jnp.asarray(jph._interleave_wrow(wrow, s,
                                                                  taps)),
            jnp.asarray(wcol), s=s, step=step, wstep=wstep, taps=taps,
            left=left, interpret=True)
        outs.append(np.asarray(y)[0, :h * s, :w * s])
    return frames, outs


@pytest.mark.parametrize("i", range(len(STREAM_SIZES)))
def test_mixed_size_stream_equals_jax_bucket_program(bucket_program, i):
    frames, want = bucket_program
    fn = configs.mixed_size_fn({})
    for f in frames[:i]:                      # one cache across the sizes
        fn(torch.from_numpy(f))
    got = fn(torch.from_numpy(frames[i])).numpy()
    assert _delta(got, want[i]) <= 1


def test_mixed_size_stream_row_keeps_a_plan_per_size():
    row, pending = configs.run_mixed_size_stream(geo=configs.SMALL, dev=CPU)
    configs.hold(pending)
    assert row["max_u8_delta"] <= 1
    assert sorted(row["plan_build_ms"]) == sorted(
        f"{h}x{w}" for h, w in configs.SMALL.mixed_sizes)
    assert row["expected_launches"]["resize_phase"] == 4


# ---- (c) the microbatch of eight through one launch of C ----------------


def test_microbatch8_equals_single_calls_and_jax_flat():
    frames = configs.microbatch_frames(configs.SMALL)
    s = configs.SMALL.configs["c1_256_gray_2x"][2]
    fn = configs.microbatch_fn(s, {})
    got = fn(torch.from_numpy(frames))
    assert got.shape[0] == configs.MICROBATCH
    for i in range(configs.MICROBATCH):
        assert torch.equal(got[i], fn(torch.from_numpy(frames[i:i + 1]))[0])
    want = np.asarray(jmx.resize_mxu(frames, float(s), "bicubic",
                                     layout="flat", interpret=True))
    assert _delta(got.numpy(), want[:, :got.shape[1], :got.shape[2]]) <= 1


def test_microbatch8_row_is_held_and_equal_to_singles():
    row, pending = configs.run_microbatch8(geo=configs.SMALL, dev=CPU)
    configs.hold(pending)
    assert row["max_u8_delta"] <= 1 and row["equal_to_single_launches"]
    assert len(pending[0][1]) == configs.MICROBATCH


# ---- (d) the latency curve's microbatch size ----------------------------


def _groups_of(cls, n, frames):
    """The group lengths ``cls.stream(microbatch="auto")`` dispatches for
    ``frames`` NxN RGBA frames with every size below its threshold: a
    subclass (of the JAX package's or the port's upscaler) whose
    threshold is raised past N² and whose single and batched calls only
    record their frame counts (the JAX ``Upscaler`` serves a single frame
    through ``_fn``)."""
    seen = []

    def record(k):
        seen.append(k)
        return torch.zeros((k, 1, 1, 4), dtype=torch.uint8)
    spy = type("Spy", (cls,), {
        "MICROBATCH_THRESHOLD_PX": n * n + 1, "method": "bicubic",
        "bucket": None, "_mxu_ok": lambda self, img: False,
        "_fn": lambda self: lambda x: record(1)[0],
        "__call__": lambda self, img, fetch=True: record(1)[0],
        "batch": lambda self, g, fetch=True: record(len(g))})
    for _ in spy.stream(spy.__new__(spy),
                        [np.zeros((n, n, 4), np.uint8)] * frames):
        pass
    return seen


def test_microbatch_thresholds_agree():
    """The curve's group size is the stream's own: for each size, two
    groups of :func:`configs.microbatch_for` frames are what
    ``Upscaler.stream(microbatch="auto")`` makes of that many frames
    below its threshold."""
    for n in configs.LATENCY_SIZES:
        g = configs.microbatch_for(n, Upscaler.MICROBATCH_TARGET_PX,
                                   configs.FULL.max_group)
        assert _groups_of(Upscaler, n, 2 * g) == [g, g]


@pytest.mark.parametrize("n", configs.LATENCY_SIZES)
def test_microbatch_for_is_the_jax_formula(n):
    """The port's ``group_size`` sizes classical groups as the JAX
    ``Upscaler.stream`` does (``round(2**20 / px)``): both streams, below
    their thresholds, split the same frames into the same groups."""
    g = serving.group_size("auto", n * n, None, Upscaler.MICROBATCH_TARGET_PX)
    frames = 2 * g + 1
    want = _groups_of(JUpscaler, n, frames)
    assert _groups_of(Upscaler, n, frames) == want
    assert want == ([g, g, 1] if g > 1 else [1] * frames)
    assert configs.microbatch_for(n, Upscaler.MICROBATCH_TARGET_PX,
                                   configs.FULL.max_group) == min(
        g, configs.FULL.max_group)


@pytest.mark.parametrize("n", configs.LEARNED_SIZES)
def test_model_microbatch_is_the_jax_formula(n):
    """The port's ``group_size`` sizes learned groups as the JAX
    ``ModelUpscaler.stream`` does (``round(2**18 / px)``)."""
    target = ModelUpscaler.MICROBATCH_TARGET_PX
    g = serving.group_size("auto", n * n, None, target)
    frames = 2 * g + 1
    want = _groups_of(JModelUpscaler, n, frames)
    assert _groups_of(ModelUpscaler, n, frames) == want
    assert want == ([g, g, 1] if g > 1 else [1] * frames)
    assert configs.microbatch_for(n, target, configs.FULL.max_group) == min(
        g, configs.FULL.max_group)


# ---- (e) the scripts' constants -----------------------------------------


@pytest.fixture(scope="module")
def jax_method_throughput():
    return _module(ROOT / "scripts" / "method_throughput.py",
                   "jax_method_throughput")


def test_configs_are_the_jax_scripts():
    nodes = _main_literals("bench_configs")
    assert _for_iter(nodes, "key", "h", "w", "s") == configs.CONFIGS


def test_mixed_buckets_are_the_jax_scripts():
    nodes = _main_literals("bench_configs")
    assert _for_iter(nodes, "s", "n") == configs.MIXED_BUCKETS
    batch = next(n for n in nodes if isinstance(n, ast.Call)
                 and getattr(n.func, "attr", "") == "integers"
                 and len(n.args) >= 3
                 and isinstance(n.args[2], ast.Tuple)
                 and len(n.args[2].elts) == 4)
    assert ast.literal_eval(batch.args[2]) == configs.MIXED_BATCH


def test_mixed_sizes_are_the_jax_scripts():
    nodes = _main_literals("bench_configs")
    assert tuple(map(tuple, _assigned(nodes, "sizes"))) == \
        configs.MIXED_SIZES
    assert _assigned(nodes, "s", "c", "bucket")[:2] == (
        configs.MIXED_SIZE_SCALE, 4)


def test_latency_sizes_are_the_jax_scripts():
    nodes = _main_literals("latency_curve")
    assert _for_iter(nodes, "n") == configs.LATENCY_SIZES
    assert _assigned(nodes, "scale", "method") == (configs.LATENCY_SCALE,
                                                   configs.METHOD)


@pytest.mark.parametrize("name", ["REFERENCE_MS", "LR_H", "LR_W", "SCALE"])
def test_method_constants_are_the_jax_scripts(jax_method_throughput, name):
    assert getattr(methods, name) == getattr(jax_method_throughput, name)


def test_method_sections_are_the_jax_scripts():
    nodes = _main_literals("method_throughput")
    sets = [ast.literal_eval(n) for n in nodes if isinstance(n, ast.Set)]
    assert set(methods.SECTIONS) in sets
    assert _for_iter(nodes, "name", "ref_key") == methods.NEURAL
    assert _for_iter(nodes, "label", "hh", "ww") == methods.FULL.downsample
    assert _for_iter(nodes, "scale") == (1.5, 2.5)


# ---- (f) the scripts with --cpu: exit 0, the JAX rows' keys -------------

#: a TPU-named key of the JAX rows and the port's name for it
RENAMED = {"max_u8_delta_tpu": "max_u8_delta"}


def _jax_keys(row):
    return {RENAMED.get(k, k) for k in row}


@pytest.fixture(scope="module")
def cpu_tables(tmp_path_factory):
    """Each script's ``main(["--cpu"])`` with its tables written to a
    temporary directory: {script: (exit code, table)}."""
    out = {}
    mp = pytest.MonkeyPatch()
    mp.setattr(configs, "RESULTS_DIR", tmp_path_factory.mktemp("results"))
    try:
        for name, table in (("bench_configs", "bench_configs"),
                            ("latency_curve", "latency_curve"),
                            ("method_throughput", "method_throughput"),
                            ("launch_trace", "launch_trace")):
            mod = _module(ROOT / "scripts" / f"torch_{name}.py",
                          f"torch_{name}")
            rc = mod.main(["--cpu"])
            out[name] = (rc, json.loads(
                (configs.RESULTS_DIR / f"{table}.json").read_text()))
    finally:
        mp.undo()
    return out


def _record(name):
    return json.loads((ROOT / "results" / f"{name}.json").read_text())


@pytest.mark.parametrize("name", ["bench_configs", "latency_curve",
                                  "method_throughput", "launch_trace"])
def test_script_exits_0_on_the_cpu(cpu_tables, name):
    assert cpu_tables[name][0] == 0


def test_bench_configs_rows_hold_the_jax_rows_keys(cpu_tables):
    rows = cpu_tables["bench_configs"][1]["configs"]
    for key, jrow in _record("bench_configs")["configs"].items():
        assert _jax_keys(jrow) <= set(rows[key]), key
    assert rows["c1_256_gray_2x"]["c"] == 4
    assert rows["c1_256_gray_2x_c1"]["c"] == 1
    assert all(r["max_u8_delta"] <= 1 for r in rows.values())


def test_latency_rows_hold_the_jax_rows_keys(cpu_tables):
    rows = cpu_tables["latency_curve"][1]["rows"]
    jkeys = set().union(*map(_jax_keys,
                             _record("latency_curve")["rows"].values()))
    assert len(rows) == len(configs.SMALL.latency_sizes)
    for row in rows.values():
        assert jkeys <= set(row)
        assert row["batched_equal_to_single_launches"]


def test_method_rows_hold_the_jax_rows_keys(cpu_tables):
    out = cpu_tables["method_throughput"][1]
    record = _record("method_throughput")
    # the JAX script's reference-checkpoint row reads a checkpoint the
    # repository does not hold
    for name, jrow in record.items():
        if name in ("_provenance", "ref_1e-3-30"):
            continue
        assert name in out, name
        assert _jax_keys(jrow) <= set(out[name]), name
    for name in ("wp-1e-3-120", "wp-adaptive-1e-3-120"):
        assert out[name]["checkpoint"] == f"model/{name}"


# ---- (g) check_parity at 1 and 3 channels -------------------------------


@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("scale", [2, 3])
@pytest.mark.parametrize("impl", ["gather", "matmul", "pallas_mxu",
                                  "pallas_phase"])
def test_check_parity_takes_channels(impl, scale, c):
    got = suite._impl_output(impl, torch.from_numpy(
        suite._make_input(24, 16, c)), scale, "bicubic", CPU)
    want = jo.resize_oracle(suite._make_input(24, 16, c), float(scale))
    d = suite.check_parity(scale, impl=impl, h=24, w=16, c=c, device="cpu")
    assert d == _delta(got.numpy().reshape(want.shape), want) <= 1


# ---- the per-method rows hold the output of the call they time ----------


@pytest.mark.parametrize("impl,scale", [
    ("pallas_mxu", 1.5), ("pallas_mxu", 2.5), ("pallas_mxu", 4),
    ("pallas_phase", 4), ("pallas_phase_planar", 4), ("phase", 2.5),
    ("matmul", 1.5)])
def test_resize_row_holds_its_timed_input(impl, scale):
    h, w = methods.SMALL.hd
    row = methods.resize_row(h, w, scale, "bicubic", impl, dev=CPU)
    img = suite._make_input(h, w)
    got = suite._impl_output(impl, torch.from_numpy(img), scale, "bicubic",
                             CPU)
    want = jo.resize_oracle(img, float(scale))
    assert row["max_u8_delta"] == _delta(
        got.numpy().reshape(want.shape), want) <= 1
    own = methods.OWN_KERNEL.get(impl)
    assert row["expected_launches"] == configs.expected(
        **({own: 1} if own else {}))


def test_resize_row_reads_the_output_of_its_own_call(monkeypatch):
    """A resize whose output is off by 3 u8 in one byte fails the row."""
    make = suite._resize_for_impl

    def off_by_three(impl, scale, method, cache):
        fn = make(impl, scale, method, cache)

        def bad(x):
            out = fn(x).clone()
            out.view(-1)[5] += 3
            return out
        return bad
    monkeypatch.setattr(suite, "_resize_for_impl", off_by_three)
    h, w = methods.SMALL.hd
    row = methods.resize_row(h, w, 2, "bicubic", "pallas_mxu", dev=CPU)
    assert row["max_u8_delta"] >= 2
    assert methods.failures({"r": row}, False)


@pytest.mark.parametrize("c", [1, 4])
@pytest.mark.parametrize("scale", [2, 3, 4])
def test_planar_words_to_hwc_is_the_hwc_layout(scale, c):
    from bicubic_interpolation_model_tpu_torch.ops.adaptive_fused import (
        adaptive_resize_fused)
    x = torch.from_numpy(np.random.default_rng(scale * 10 + c).integers(
        0, 256, (9, 13, c), dtype=np.uint8))
    words = adaptive_resize_fused(x, scale, layout="planar")
    hwc = adaptive_resize_fused(x, scale)
    assert torch.equal(methods.planar_words_to_hwc(words, c), hwc)


@pytest.mark.parametrize("h,w", [(12, 20), (1030, 6)])
def test_adaptive_delta_is_the_oracles(h, w):
    """Exhaustive below 4097 output rows, every 67th row above."""
    img = np.random.default_rng(h).integers(0, 256, (h, w, 4),
                                            dtype=np.uint8)
    want = jo.adaptive_bicubic_oracle(img, 4.0)
    got = want.copy()
    got[-1, -1, 0] ^= 4             # the last row: every row is read
    got[0, 0, 1] ^= 2               # row 0: read at every stride
    d = methods.adaptive_delta(img, torch.from_numpy(got))
    assert d == (4 if want.shape[0] <= 4096 else 2)


def test_method_failures_hold_launches_exactly_on_the_card():
    row = {"max_u8_delta": 0, "launches": configs.expected(resize_mxu=2),
           "expected_launches": configs.expected(resize_mxu=1)}
    out = {"bicubic_1.5x_1080p": dict(row, candidates={
        "phase": dict(row, launches=configs.expected(),
                      expected_launches=configs.expected())})}
    assert methods.failures(out, False) == []
    bad = methods.failures(out, True)
    assert len(bad) == 1 and bad[0].startswith("bicubic_1.5x_1080p:")


def test_trace_summary_of_a_host_loop():
    """On the CPU the trace holds host ops only: no device time."""
    from torch.profiler import ProfilerActivity, profile, record_function
    x = torch.rand(32, 32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(4):
            with record_function(configs.TRACE_RANGE):
                (x @ x).sum()
    got = configs.trace_summary(prof.events(), 4, 0.01)
    assert got["device_ms"] is None and got["device_busy_share"] is None
    assert got["wall_ms"] == pytest.approx(2.5)
    assert configs.TRACE_RANGE in got["host_ops_ms"]
    assert len(got["host_ops_ms"]) <= configs.TRACE_TOP
    assert got["host_self_ms"] >= max(got["host_ops_ms"].values()) > 0
