"""The port's stream auto-microbatch policy against the card's committed
measurements (counterpart of ``tests/test_serving_policy.py``, which holds
the JAX package's policy to its TPU curve).

``results_torch/latency_curve_call{1,2,3}.json`` are three separate runs
of ``scripts/torch_latency_curve.py`` on one NVIDIA H100, committed as
written; ``results_torch/bench_configs.json`` is one run of
``scripts/torch_bench_configs.py``. The rule, the JAX package's: at a
measured size batching wins when a grouped frame takes at most 1.05 x a
frame launched alone, at the program-output boundary and as a served
``stream()`` frame with its fetch, in every call. ``stream(microbatch=
"auto")`` groups a size only where batching won, and groups every size
where it won by more than 2x; each ``MICROBATCH_THRESHOLD_PX`` is the LR
pixel count of the smallest size at which batching did not win (one more
than the largest size where it won at every size). Grouped and ungrouped
streams deliver the same frames in order (±1 u8 for the plain versions).
"""

import json
import pathlib

import numpy as np
import pytest

from bicubic_interpolation_model_tpu import serving as jserving
from bicubic_interpolation_model_tpu_torch.bench import configs
from bicubic_interpolation_model_tpu_torch.serving import (
    ModelUpscaler, Upscaler, group_size)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CARD_DIR = ROOT / "results_torch"
SLACK = 1.05
#: each curve: its table in a committed call, its upscaler class
CURVES = {"classical": (lambda t: t["rows"], Upscaler),
          "learned": (lambda t: t["learned"]["rows"], ModelUpscaler)}


def _px(size):
    h, w = (int(v) for v in size.split("x"))
    return h * w


def _auto_group(cls, px):
    return group_size("auto", px, cls.MICROBATCH_THRESHOLD_PX,
                      cls.MICROBATCH_TARGET_PX)


def _wins(row):
    return (row["microbatch"] > 1
            and row["batched_ms_per_frame"] <= SLACK * row["single_ms"]
            and row["served_grouped_ms_per_frame"]
            <= SLACK * row["served_single_ms_per_frame"])


@pytest.fixture(scope="module")
def calls():
    paths = sorted(CARD_DIR.glob("latency_curve_call*.json"))
    assert [p.name for p in paths] == [f"latency_curve_call{i}.json"
                                       for i in (1, 2, 3)]
    return [json.loads(p.read_text()) for p in paths]


def _tables(calls, curve):
    rows_of, cls = CURVES[curve]
    tables = [rows_of(c) for c in calls]
    assert all(sorted(t) == sorted(tables[0]) for t in tables)
    return tables, cls


@pytest.mark.parametrize("curve", CURVES)
def test_auto_never_groups_where_batching_lost(calls, curve):
    """A size at which grouping did not win in some call is not grouped."""
    tables, cls = _tables(calls, curve)
    for size in tables[0]:
        if not all(_wins(t[size]) for t in tables):
            assert _auto_group(cls, _px(size)) == 1, (curve, size)


@pytest.mark.parametrize("curve", CURVES)
def test_auto_groups_where_batching_wins_big(calls, curve):
    """A size at which a grouped frame ran more than 2x faster on the
    device in every call is grouped, at the curve's group size."""
    tables, cls = _tables(calls, curve)
    big = [size for size in tables[0]
           if all(t[size]["microbatch"] > 1 and 2 * t[size][
               "batched_ms_per_frame"] < t[size]["single_ms"]
               for t in tables)]
    assert big, f"no decisive win in the {curve} curve"
    for size in big:
        n = int(size.split("x")[0])
        g = configs.microbatch_for(n, cls.MICROBATCH_TARGET_PX,
                                   configs.FULL.max_group)
        assert _auto_group(cls, _px(size)) == g > 1, (curve, size)


@pytest.mark.parametrize("curve", CURVES)
def test_threshold_is_the_one_the_rule_derives(calls, curve):
    """The constant is exactly what the committed calls give, so a curve
    recommitted beside a stale constant fails."""
    tables, cls = _tables(calls, curve)
    sizes = sorted(tables[0], key=_px)
    lost = [s for s in sizes if not all(_wins(t[s]) for t in tables)]
    want = _px(lost[0]) if lost else _px(sizes[-1]) + 1
    assert cls.MICROBATCH_THRESHOLD_PX == want
    assert configs.threshold_from(tables) == want


@pytest.mark.parametrize("curve", CURVES)
def test_every_size_is_measured_at_the_streams_group(calls, curve):
    """Each batched row groups as the stream would below its threshold,
    and compares (``batching_faster`` set) wherever that is two frames or
    more."""
    tables, cls = _tables(calls, curve)
    for t in tables:
        for size, row in t.items():
            n = int(size.split("x")[0])
            assert row["microbatch"] == configs.microbatch_for(
                n, cls.MICROBATCH_TARGET_PX, configs.FULL.max_group)
            assert (row["batching_faster"] is None) == (row["microbatch"]
                                                        == 1)


@pytest.mark.parametrize("curve", CURVES)
def test_served_rows_are_timed_over_a_window(calls, curve):
    """Each served mode is the median of ``SERVED_PASSES`` passes, each
    lasting at least ``SERVED_WINDOW_S`` (0.25 s) over whole groups, not
    one short pass."""
    tables, _ = _tables(calls, curve)
    window_ms = configs.SERVED_WINDOW_S * 1e3
    for t in tables:
        for size, row in t.items():
            for mode, per in (("served_grouped", row["microbatch"]),
                              ("served_single", 1)):
                passes = row[f"{mode}_passes_ms_per_frame"]
                ks = row[f"{mode}_frames_per_pass"]
                assert len(passes) == len(ks) == configs.SERVED_PASSES
                assert row[f"{mode}_ms_per_frame"] == sorted(passes)[
                    len(passes) // 2]
                for k, ms in zip(ks, passes):
                    assert k % per == 0, (size, mode, k)
                    assert k * ms >= window_ms * (1 - 1e-9), (size, mode)


def test_every_file_comes_from_one_source():
    """The four committed runs name one ``source_sha256``
    (``configs.source_sha256``: the port and the two scripts), so one
    code measured them all."""
    shas = {json.loads(p.read_text())["_provenance"]["source_sha256"]
            for p in sorted(CARD_DIR.glob("*.json"))}
    assert len(shas) == 1 and len(shas.pop()) == 64


def test_auto_respects_the_c1_microbatch_row():
    """``bench_configs.json``'s c1 rows (256x256 -> 2x): grouping eight
    frames slower than one a launch forbids grouping 256² frames; more
    than 2x faster requires it."""
    cfg = json.loads((CARD_DIR / "bench_configs.json").read_text())[
        "configs"]
    single = cfg["c1_256_gray_2x"]["ms_per_frame"]
    grouped = cfg["c1_256_gray_2x_microbatch8"]["ms_per_frame"]
    groups = _auto_group(Upscaler, 256 * 256) > 1
    if grouped > single:
        assert not groups
    if 2 * grouped < single:
        assert groups


@pytest.mark.parametrize("name", ["latency_curve_call1.json",
                                  "latency_curve_call2.json",
                                  "latency_curve_call3.json",
                                  "bench_configs.json"])
def test_every_file_is_a_card_run(name):
    """Each committed file names an NVIDIA card and its power limit (as
    ``nvidia-smi --query-gpu=name,power.limit`` gives them), the torch
    version, the source revision and the date, with backend ``cuda``: no
    CPU run is committed by mistake."""
    table = json.loads((CARD_DIR / name).read_text())
    prov = table["_provenance"]
    assert prov["backend"] == table["backend"] == "cuda"
    card, power = prov["card"].rsplit(", ", 1)
    assert card.startswith("NVIDIA ") and power.endswith(" W")
    assert float(power[:-2]) > 0
    assert "+cu" in prov["torch"] and prov["commit"] and prov["date"]


def _frames(seed, n, h, w):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
            for _ in range(n)]


def _same_in_order(got, ref, n):
    assert len(got) == len(ref) == n
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        assert np.abs(g.astype(np.int64) - r.astype(np.int64)).max() <= 1


def _grouped(up, frames):
    """``up.stream(frames, microbatch="auto")``, checked to have put every
    frame into one ``batch`` call."""
    seen = []
    batch = up.batch
    up.batch = lambda g, fetch=True: seen.append(len(g)) or batch(g, fetch)
    got = list(up.stream(frames, microbatch="auto"))
    assert seen == [len(frames)]
    return got


def _newly_grouped(cls, jax_cls, sizes):
    """The smallest measured size that ``cls``'s threshold groups and the
    JAX package's (set from its TPU curve) does not; the largest size that
    ``cls`` groups if there is none."""
    grouped = [n for n in sizes if _auto_group(cls, n * n) > 1]
    new = [n for n in grouped if n * n >= jax_cls.MICROBATCH_THRESHOLD_PX]
    return min(new) if new else max(grouped)


def test_upscaler_grouped_stream_equals_ungrouped():
    """On the CPU, at a frame size the card's threshold groups, auto and
    no grouping give the same frames in order."""
    n = _newly_grouped(Upscaler, jserving.Upscaler, configs.LATENCY_SIZES)
    up = Upscaler(scale=4, device="cpu")
    frames = _frames(16, 3, n, n)
    _same_in_order(_grouped(up, frames),
                   list(up.stream(frames, microbatch=None)), 3)


def test_model_upscaler_grouped_stream_equals_ungrouped():
    """The same for ``ModelUpscaler`` on ``model/wp-1e-3-120``."""
    n = _newly_grouped(ModelUpscaler, jserving.ModelUpscaler,
                       configs.LEARNED_SIZES)
    up = ModelUpscaler(str(ROOT / configs.LEARNED_MODEL), device="cpu")
    frames = _frames(17, 2, n, n)
    _same_in_order(_grouped(up, frames),
                   list(up.stream(frames, microbatch=None)), 2)
