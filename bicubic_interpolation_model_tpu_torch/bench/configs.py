"""The BASELINE configurations and the latency curve, on the card.

Counterpart of the bodies of the JAX package's ``scripts/bench_configs.py``
and ``scripts/latency_curve.py``; the scripts that run them are
``scripts/torch_bench_configs.py`` and ``scripts/torch_latency_curve.py``,
and ``chip_smoke.py``'s ``configs`` and ``latency_curve`` phases run the same
functions. Every row drives kernel C (``ops/mxu.resize_mxu``) or kernel D
(``ops/phase.resize_phase``) at 2x, 3x or 4x bicubic:

- ``c1_256_gray_2x``, ``c2_512_rgb_4x``, ``c4_4k_4x``,
  ``c5_1080p_2x_stream`` (:func:`run_single`): one frame, the faster of C
  and D among those within 1 u8 of the oracle. The JAX row of config 1
  runs an RGBA frame (its ``_make_input`` defaults to 4 channels), so the
  key keeps C = 4 and ``c1_256_gray_2x_c1`` runs a true gray frame beside
  it;
- ``c1_256_gray_2x_microbatch8`` (:func:`run_microbatch8`): the c1 frame
  XOR 0..7, eight to one launch of C (``layout="flat"``);
- ``c3_batch64_mixed`` (:func:`run_mixed_batch`): 64 RGBA 256x256 frames
  split into three scale buckets, one launch of D per bucket. The JAX
  script gives each bucket ``batch[:n]`` (frames 0-21 three times) while
  its docstring splits the batch; here bucket i takes its own frames;
- ``c6_mixed_size_stream`` (:func:`run_mixed_size_stream`): four frame
  sizes at 2x, D per frame at its own size, plans cached per size in one
  weight cache (the JAX row pads to one 768x1280 bucket program; a CUDA
  kernel takes its extents at run time, so there is no bucket);
- ``c5_1080p_2x_stream_served`` (:func:`run_served_stream`):
  ``serving.Upscaler(scale=2).stream()`` over 16 fetched 1080p frames,
  what a user of BASELINE config 5 ("1080p@60fps continuous 2x") sees;
- the latency curves (:func:`run_latency_curve`), the evidence for
  ``serving``'s ``MICROBATCH_THRESHOLD_PX``: NxN RGBA -> 4x through C
  (:func:`latency_point`) and through ``ModelUpscaler`` on
  :data:`LEARNED_MODEL` (kernels A and B, :func:`learned_point`), one frame
  a launch against the group ``stream(microbatch="auto")`` makes below its
  threshold, whatever the threshold now is, at the program-output boundary
  and as served ``stream()`` frames with their fetches
  (:func:`served_point`); :func:`threshold_from` derives the threshold
  from such tables.

Every output is held to the float64 oracle (``core/oracle``) at its full
geometry: every 67th row of outputs taller than 4096 rows, every row
otherwise (``suite.parity_rows``); the oracle runs once for all rows of a
table (:func:`hold`). Each row counts the launches of the seven kernels'
wrappers over one drive of its work (:func:`counted`). On the card the
rows are timed by the suite's CUDA-event slopes over inputs rotated past
the L2; on the CPU (the kernels' plain versions, :data:`SMALL` shapes)
nothing is timed and the time keys are None.
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import json
import pathlib
import re
import statistics
import time

import numpy as np
import torch

from ..ops import adaptive_fused, banded, interleave, mxu, packed_tail, phase
from . import labs, suite

#: BASELINE.json configs 1, 2, 4 and 5 as the JAX script runs them: (LR
#: rows, LR columns, scale)
CONFIGS = {
    "c1_256_gray_2x": (256, 256, 2),
    "c2_512_rgb_4x": (512, 512, 4),
    "c4_4k_4x": (2160, 3840, 4),
    "c5_1080p_2x_stream": (1080, 1920, 2),
}
#: the candidates of a single-frame row: kernel C, kernel D
SINGLE_IMPLS = ("pallas_mxu", "pallas_phase")
KERNEL_OF = {"pallas_mxu": "resize_mxu", "pallas_phase": "resize_phase"}
MICROBATCH = 8
#: config 3: a seeded [64, 256, 256, 4] batch, (scale, frames) per bucket
MIXED_BATCH = (64, 256, 256, 4)
MIXED_BUCKETS = ((2, 22), (3, 21), (4, 21))
#: config 6: four frame sizes at 2x
MIXED_SIZES = ((720, 1280), (704, 1238), (768, 1222), (666, 1200))
MIXED_SIZE_SCALE = 2
STREAM_FRAMES = 16
LATENCY_SIZES = (128, 256, 384, 512, 768, 1024)
LATENCY_SCALE = 4
#: the learned curve: NxN RGBA frames through ModelUpscaler on this
#: checkpoint (4x)
LEARNED_MODEL = "model/wp-1e-3-120"
LEARNED_SIZES = (64, 96, 128, 192, 256, 384, 512)
#: a served row times each mode in this many passes, in turns, each
#: lasting at least SERVED_WINDOW_S seconds (the suite's slope window)
SERVED_PASSES = 3
SERVED_WINDOW_S = suite.SLOPE_MIN_DELTA_S
#: batching wins at a size when a grouped frame takes at most this many
#: times a frame launched alone (the JAX policy test's slack)
WIN_SLACK = 1.05
METHOD = "bicubic"

ROOT = pathlib.Path(__file__).resolve().parents[2]
RESULTS_DIR = ROOT / "build" / "results"
#: the card's committed runs of the measurement scripts
CARD_RESULTS_DIR = ROOT / "results_torch"


@dataclasses.dataclass(frozen=True)
class Geometry:
    """The shapes a table runs at."""
    configs: dict
    mixed_batch: tuple
    mixed_buckets: tuple
    mixed_sizes: tuple
    stream_frames: int
    latency_sizes: tuple
    learned_sizes: tuple = ()
    #: the most frames a latency row puts in one launch (the JAX
    #: script's cap)
    max_group: int = 64


FULL = Geometry(CONFIGS, MIXED_BATCH, MIXED_BUCKETS, MIXED_SIZES,
                STREAM_FRAMES, LATENCY_SIZES, LEARNED_SIZES)
#: the same rows at a small size, for the plain versions on the CPU
SMALL = Geometry(
    {"c1_256_gray_2x": (16, 16, 2), "c2_512_rgb_4x": (16, 24, 4),
     "c4_4k_4x": (27, 48, 4), "c5_1080p_2x_stream": (18, 32, 2)},
    (7, 24, 40, 4), ((2, 3), (3, 2), (4, 2)),
    ((24, 40), (22, 37), (26, 35), (20, 33)), 4, (8, 16, 24), (8, 12), 4)

#: the seven kernels' wrappers, whose ``launches`` count their launches
WRAPPERS = {"packed_tail_fused": packed_tail.packed_tail_fused,
            "packed_tail": packed_tail.packed_tail,
            "interleave_planar_u32": interleave.interleave_planar_u32,
            "resize_mxu": mxu.resize_mxu,
            "resize_phase": phase.resize_phase,
            "adaptive_resize_fused": adaptive_fused.adaptive_resize_fused,
            "resize_banded": banded.resize_banded}


def launch_counts() -> dict:
    """The seven kernels' launch counts as their wrappers hold them."""
    return {k: fn.launches for k, fn in WRAPPERS.items()}


def counted(fn):
    """(``fn()``, the launches of each of the seven kernels it made)."""
    before = launch_counts()
    out = fn()
    return out, {k: v - before[k] for k, v in launch_counts().items()}


def expected(**own) -> dict:
    """Launches of the seven kernels: ``own`` and none of the others."""
    return {k: own.get(k, 0) for k in WRAPPERS}


def microbatch_for(n: int, target_px: int, cap: int) -> int:
    """Frames per launch of a latency row for NxN frames: the group
    ``stream(microbatch="auto")`` makes below its threshold
    (``serving.group_size`` with no threshold, ``target_px`` pixels a
    launch), at most ``cap`` (``Geometry.max_group``)."""
    from ..serving import group_size
    return min(cap, group_size("auto", n * n, None, target_px))


def device_and_card(cpu: bool) -> tuple[torch.device, str]:
    """``labs.lab_device`` with the kernels built on the card, so that no
    plan cost holds the nvcc build."""
    dev, card = labs.lab_device(cpu)
    if dev.type == "cuda":
        from ..runtime import build
        build.library()
    return dev, card


def _timed(dev) -> bool:
    return dev.type == "cuda"


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def plan_build_ms(fn, dev):
    """The first call of ``fn`` (which builds and uploads its plans) less
    a second, on the host clock with the fence; None on the CPU."""
    if not _timed(dev):
        fn()
        return None
    sync = lambda: _sync(dev)
    sync()
    return suite._host_ms(fn, sync) - suite._host_ms(fn, sync)


def untimed_row(h, w, scale, method, impl) -> dict:
    """``suite.bench_resize_ondevice``'s keys with no times (the CPU)."""
    out_px = int(h * scale) * int(w * scale)
    return {"impl": impl, "method": method, "shape": f"{h}x{w}x{scale}",
            "ms_per_frame": None, "out_mpix": out_px / 1e6,
            "gpix_per_s": None, "plan_build_ms": None,
            "ms_per_frame_with_fetch": None}


def _gpix(out_px, seconds):
    return None if seconds is None else out_px / seconds / 1e9


def to_ms(seconds):
    return None if seconds is None else seconds * 1e3


def run_single(key, c=4, *, geo=FULL, dev):
    """Config ``key`` on :func:`suite._make_input`'s frame of ``c``
    channels through kernels C and D. Returns (row, pending): the row
    holds each candidate (``candidates``: the JAX row's keys from
    ``suite.bench_resize_ondevice``, ``c``, ``launches``) and takes the
    faster passing one's keys in :func:`pick_best` once :func:`hold` has
    set each candidate's ``max_u8_delta``."""
    h, w, s = geo.configs[key]
    img = suite._make_input(h, w, c)
    x = torch.from_numpy(img).to(dev)
    row = {"shape": f"{h}x{w}x{s}", "method": METHOD, "c": c,
           "candidates": {}}
    pending = []
    for impl in SINGLE_IMPLS:
        fn = suite._resize_for_impl(impl, s, METHOD, {})
        got, launches = counted(lambda: fn(x))
        _sync(dev)
        case = suite.parity_case(img, s, got)
        del got
        cand = (suite.bench_resize_ondevice(h, w, s, METHOD, impl=impl, c=c,
                                            device=dev)
                if _timed(dev) else untimed_row(h, w, s, METHOD, impl))
        cand.update(c=c, launches=launches,
                    expected_launches=expected(**{KERNEL_OF[impl]: 1}))
        row["candidates"][impl] = cand
        pending.append((cand, [case]))
    return row, pending


def pick_best(row):
    """The single-frame row takes the keys of its fastest candidate within
    1 u8 of the oracle (the first such on the CPU, where nothing is timed),
    and each candidate's GPix/s as ``<impl>_gpix_per_s``. A row with no
    passing candidate keeps ``max_u8_delta`` of the worst: the table
    fails."""
    cands = list(row["candidates"].values())
    ok = [cd for cd in cands if cd["max_u8_delta"] <= 1]
    if ok:
        best = max(ok, key=lambda cd: cd["gpix_per_s"] or 0.0)
    else:
        best = max(cands, key=lambda cd: cd["max_u8_delta"])
    for k, v in best.items():
        if k != "expected_launches":
            row[k] = v
    row["expected_launches"] = best["expected_launches"]
    for cd in cands:
        row[f"{cd['impl']}_gpix_per_s"] = cd["gpix_per_s"]
    return row


def microbatch_frames(geo=FULL) -> np.ndarray:
    """The c1 frame (RGBA, as the JAX row) XOR 0..7."""
    h, w, _ = geo.configs["c1_256_gray_2x"]
    one = suite._make_input(h, w)
    return np.stack([one ^ np.uint8(i) for i in range(MICROBATCH)])


def microbatch_fn(scale, weight_cache=None):
    """``fn(batch)``: the batch through kernel C in one launch,
    ``layout="flat"`` ([B, Ho, Wo*C], the serving boundary)."""
    return lambda b: mxu.resize_mxu(b, float(scale), METHOD, layout="flat",
                                    weight_cache=weight_cache)


def run_microbatch8(*, geo=FULL, dev):
    """:func:`microbatch_frames` through :func:`microbatch_fn`; each frame
    also equal to its own launch. ms per frame = the launch's slope / 8."""
    h, w, s = geo.configs["c1_256_gray_2x"]
    frames = microbatch_frames(geo)
    b8 = torch.from_numpy(frames).to(dev)
    fn = microbatch_fn(s, {})
    plan_ms = plan_build_ms(lambda: fn(b8), dev)
    got, launches = counted(lambda: fn(b8))
    singles = all(torch.equal(got[i], fn(b8[i:i + 1])[0])
                  for i in range(MICROBATCH))
    pending_cases = [suite.parity_case(frames[i], s, got[i])
                     for i in range(MICROBATCH)]
    del got
    per = (suite.chained_bench(fn, b8, k_lo=4, k_hi=40)
           / MICROBATCH if _timed(dev) else None)
    out_px = int(h * s) * int(w * s)
    row = {"impl": "pallas_mxu", "method": METHOD, "shape": f"{h}x{w}x{s}",
           "c": 4, "ms_per_frame": to_ms(per), "out_mpix": out_px / 1e6,
           "gpix_per_s": _gpix(out_px, per),
           "note": f"{MICROBATCH} frames per launch of kernel C, batch on "
                   "the grid (serving stream microbatch path)",
           "plan_build_ms": plan_ms, "launches": launches,
           "expected_launches": expected(resize_mxu=1),
           "equal_to_single_launches": singles}
    return row, [(row, pending_cases)]


def mixed_batch(geo=FULL, seed=0) -> np.ndarray:
    """Config 3's seeded uint8 batch."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, geo.mixed_batch, dtype=np.uint8)


def mixed_batch_fn(buckets, weight_cache=None):
    """``fn(batch)``: the batch split into ``buckets`` ((scale, frames),
    in order), one launch of kernel D per bucket; a list of outputs."""
    offsets = np.cumsum([0] + [n for _, n in buckets])
    return lambda b: [phase.resize_phase(b[o:o + n], s, METHOD,
                                         weight_cache=weight_cache)
                      for (s, n), o in zip(buckets, offsets)]


def run_mixed_batch(*, geo=FULL, dev):
    """Config 3: :func:`mixed_batch` through :func:`mixed_batch_fn`;
    ``seconds`` per batch of 64."""
    frames = mixed_batch(geo)
    batch = torch.from_numpy(frames).to(dev)
    buckets = geo.mixed_buckets
    if sum(n for _, n in buckets) != frames.shape[0]:
        raise ValueError(f"buckets {buckets} do not cover the batch")
    cache: dict = {}
    fn = mixed_batch_fn(buckets, cache)
    plan_ms = plan_build_ms(lambda: fn(batch), dev)
    outs, launches = counted(lambda: fn(batch))
    cases, i = [], 0
    for (s, n), out in zip(buckets, outs):
        cases += [suite.parity_case(frames[i + j], s, out[j])
                  for j in range(n)]
        i += n
    del outs
    per = (suite.chained_bench(fn, batch, k_lo=2, k_hi=20)
           if _timed(dev) else None)
    h, w = geo.mixed_batch[1:3]
    out_px = sum(n * h * s * w * s for s, n in buckets)
    row = {"impl": "pallas_phase", "method": METHOD, "c": 4,
           "batch": list(geo.mixed_batch),
           "buckets": [list(b) for b in buckets],
           "seconds": per, "ms_per_batch": to_ms(per),
           "out_mpix": out_px / 1e6, "gpix_per_s": _gpix(out_px, per),
           "note": f"{frames.shape[0]} images, {len(buckets)} scale "
                   "buckets, one launch of kernel D per bucket, CUDA-event "
                   "slope",
           "plan_build_ms": plan_ms, "launches": launches,
           "expected_launches": expected(resize_phase=len(buckets))}
    return row, [(row, cases)]


def mixed_size_frames(geo=FULL, seed=6) -> list:
    """Config 6's seeded RGBA frames, one per size."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
            for h, w in geo.mixed_sizes]


def mixed_size_fn(weight_cache=None):
    """``fn(frame)``: one frame of config 6 through kernel D at its own
    extents, its plans kept per size in ``weight_cache``."""
    return lambda x: phase.resize_phase(x, MIXED_SIZE_SCALE, METHOD,
                                        weight_cache=weight_cache)


def run_mixed_size_stream(*, geo=FULL, dev):
    """Config 6: each frame of :func:`mixed_size_frames` through kernel D
    at its own size, the plans cached per size in one weight cache. The
    first call per size (plans built and uploaded) is timed apart,
    ``plan_build_ms`` per size; ``ms_per_frame`` is the steady slope over
    the sizes in turn."""
    s = MIXED_SIZE_SCALE
    frames = mixed_size_frames(geo)
    xs = [torch.from_numpy(f).to(dev) for f in frames]
    fn = mixed_size_fn({})
    plan_ms = {f"{h}x{w}": plan_build_ms(lambda x=x: fn(x), dev)
               for (h, w), x in zip(geo.mixed_sizes, xs)}
    outs, launches = counted(lambda: [fn(x) for x in xs])
    cases = [suite.parity_case(f, s, o) for f, o in zip(frames, outs)]
    del outs
    per = None
    if _timed(dev):
        group = lambda g: [fn(x) for x in g]
        nbytes = sum(f.nbytes for f in frames)
        copies = 1 + -(-2 * suite.L2_BYTES // nbytes)
        inputs = [tuple(x ^ k for x in xs) for k in range(copies)]
        group(inputs[0])
        _sync(dev)
        timed = lambda k: min(suite._events_s(group, inputs, k)
                              for _ in range(2))
        per = suite.chained_slope(timed, 1, 12) / len(xs)
        del inputs
    out_px = float(np.mean([h * s * w * s for h, w in geo.mixed_sizes]))
    row = {"impl": "pallas_phase", "method": METHOD, "c": 4,
           "sizes": [f"{h}x{w}" for h, w in geo.mixed_sizes], "scale": s,
           "ms_per_frame": to_ms(per),
           "fps": None if per is None else 1.0 / per,
           "gpix_per_s": _gpix(out_px, per),
           "note": f"{len(xs)} frame sizes, kernel D at each frame's own "
                   "extents, plans cached per size in one weight cache",
           "plan_build_ms": plan_ms, "launches": launches,
           "expected_launches": expected(resize_phase=len(xs))}
    return row, [(row, cases)]


def run_served_stream(*, geo=FULL, dev):
    """``Upscaler(scale=2).stream()`` over ``stream_frames`` fetched frames
    of config 5 (the c5 frame XOR i), host clock: ``ms_per_frame`` with
    each frame dropped once the next arrives (a video consumer; its pinned
    blocks go back to PyTorch's host cache) after a pass that builds the
    plans, ``ms_per_frame_kept`` with all frames kept (each holds a pinned
    block of its own). On the card each kept frame must equal kernel C's
    launch on its frame; frame 0 is held to the oracle."""
    from ..serving import Upscaler
    h, w, s = geo.configs["c5_1080p_2x_stream"]
    one = suite._make_input(h, w)
    frames = [one ^ np.uint8(i) for i in range(geo.stream_frames)]
    up = Upscaler(scale=s, device=str(dev))
    plan_ms = plan_build_ms(lambda: up(frames[0], fetch=False), dev)
    for _ in up.stream(frames):
        pass
    t0 = time.perf_counter()
    for _ in up.stream(frames):
        pass
    dropped = time.perf_counter() - t0
    t0 = time.perf_counter()
    outs, launches = counted(lambda: list(up.stream(frames)))
    kept = time.perf_counter() - t0
    cache: dict = {}
    # the CPU serves the plain graph, which kernel C's plain version
    # matches within 1 u8: the bytes are compared on the card
    equal = all(np.array_equal(o, mxu.resize_mxu(
        torch.from_numpy(f).to(dev), float(s), METHOD,
        weight_cache=cache).cpu().numpy())
        for f, o in zip(frames, outs)) if _timed(dev) else None
    cases = [suite.parity_case(frames[0], s, outs[0])]
    n = len(frames)
    per = dropped / n if _timed(dev) else None
    out_px = int(h * s) * int(w * s)
    impl = "pallas_mxu" if _timed(dev) else "auto (plain version)"
    row = {"impl": impl, "method": METHOD, "shape": f"{h}x{w}x{s}", "c": 4,
           "frames": n, "ms_per_frame": to_ms(per),
           "fps": None if per is None else 1.0 / per,
           "out_mpix": out_px / 1e6, "gpix_per_s": _gpix(out_px, per),
           "ms_per_frame_kept": to_ms(kept / n) if _timed(dev) else None,
           "note": "serving.Upscaler.stream(), each frame uploaded, resized "
                   "and fetched into pinned memory; host clock",
           "plan_build_ms": plan_ms, "launches": launches,
           "expected_launches": expected(resize_mxu=n),
           "equal_to_single_launches": equal}
    return row, [(row, cases)]


def hold(pending):
    """Set ``max_u8_delta`` of each (row, cases) in ``pending`` to the
    largest delta of its cases from the oracle, which runs once for all
    (``suite.oracle_deltas``)."""
    deltas = suite.oracle_deltas([c for _, cases in pending for c in cases],
                                 METHOD)
    i = 0
    for row, cases in pending:
        row["max_u8_delta"] = max(deltas[i:i + len(cases)])
        i += len(cases)


def run_configs(*, geo=FULL, dev, card="", emit=None) -> dict:
    """Every config row, held to the oracle (:func:`hold`), in the JAX
    script's table form: ``{"backend", "impl", "card", "configs": {key:
    row}}``. ``emit`` gets each row once it is complete."""
    rows, pending = {}, []
    kw = dict(geo=geo, dev=dev)
    for key in geo.configs:
        rows[key], p = run_single(key, **kw)
        pending += p
    rows["c1_256_gray_2x_c1"], p = run_single("c1_256_gray_2x", c=1, **kw)
    pending += p
    for key, run in (("c1_256_gray_2x_microbatch8", run_microbatch8),
                     ("c3_batch64_mixed", run_mixed_batch),
                     ("c6_mixed_size_stream", run_mixed_size_stream)):
        rows[key], p = run(**kw)
        pending += p
    rows["c5_1080p_2x_stream_served"], p = run_served_stream(geo=geo,
                                                             dev=dev)
    pending += p
    hold(pending)
    for key, row in rows.items():
        if "candidates" in row:
            pick_best(row)
        if key.startswith("c5_1080p_2x_stream") and "fps" not in row:
            ms = row["ms_per_frame"]
            row["fps"] = None if ms is None else 1e3 / ms
        row["card"] = card
        if emit:
            emit({"config": key, **row})
    return {"backend": dev.type, "impl": "best(pallas_mxu, pallas_phase)",
            "card": card, "configs": rows}


def stream_launches(n_frames: int, g: int, learned: bool) -> dict:
    """The launches of one ``stream()`` pass over ``n_frames`` same-shape
    RGBA frames at ``g`` a launch: C once a group (classical); A once a
    group and B once a one-frame group (learned: a single frame goes out
    as RGBA32 words through B, a group as uint8 HWC)."""
    groups = [g] * (n_frames // g) + ([n_frames % g] if n_frames % g else [])
    if not learned:
        return expected(resize_mxu=len(groups))
    return expected(packed_tail_fused=len(groups),
                    interleave_planar_u32=groups.count(1))


def served_frames(g: int, geo=FULL) -> int:
    """Frames of a served row: two groups, at least ``stream_frames``."""
    return max(geo.stream_frames, 2 * g)


def _served_pass(up, frames, mb, dev) -> tuple[float, int]:
    """One ``up.stream()`` pass over ``frames`` cycled, in whole groups of
    ``mb``, until :data:`SERVED_WINDOW_S` has passed, each frame fetched
    and dropped as it comes: (host ms a frame, frames)."""
    per, fed = mb or 1, 0

    def source():
        nonlocal fed
        for frame in itertools.cycle(frames):
            if fed % per == 0 and time.perf_counter() >= deadline:
                return
            fed += 1
            yield frame
    _sync(dev)
    t0 = time.perf_counter()
    deadline = t0 + SERVED_WINDOW_S
    for _ in up.stream(source(), microbatch=mb):
        pass
    _sync(dev)
    return (time.perf_counter() - t0) * 1e3 / fed, fed


def served_point(up, frames, g, *, dev, learned):
    """``up.stream()`` over same-shape ``frames`` grouped ``g`` a launch
    (``microbatch=g``: the group "auto" makes below its threshold) and one
    a launch (``microbatch=None``), every frame fetched. A pass of each
    mode over ``frames`` builds the plans and counts the launches; on the
    card :data:`SERVED_PASSES` passes of each mode, each at least
    :data:`SERVED_WINDOW_S` long (:func:`_served_pass`), then run in
    turns (grouped, single, single, grouped, ...). Returns (row keys: per
    mode the median host ms a frame, every pass's and its frames, None on
    the CPU; launches by mode; expected launches by mode)."""
    modes = {"served_grouped": g, "served_single": None}
    launches, want = {}, {}
    for key, mb in modes.items():
        _, launches[key] = counted(
            lambda: sum(1 for _ in up.stream(frames, microbatch=mb)))
        want[key] = stream_launches(len(frames), mb or 1, learned)
    passes = {key: [] for key in modes}
    fed = {key: [] for key in modes}
    if _timed(dev):
        order = list(modes)
        for i in range(SERVED_PASSES):
            for key in order if i % 2 == 0 else order[::-1]:
                ms, n = _served_pass(up, frames, modes[key], dev)
                passes[key].append(ms)
                fed[key].append(n)
    out = {}
    for key in modes:
        out[f"{key}_ms_per_frame"] = (statistics.median(passes[key])
                                      if passes[key] else None)
        out[f"{key}_passes_ms_per_frame"] = passes[key] or None
        out[f"{key}_frames_per_pass"] = fed[key] or None
    return out, launches, want


def _curve_row(n, s, g, per1, perb, served, launches, want):
    out_px = (n * s) ** 2
    return {"single_ms": to_ms(per1), "single_gpix_s": _gpix(out_px, per1),
            "microbatch": g, "batched_ms_per_frame": to_ms(perb),
            "batched_gpix_s": _gpix(out_px, perb),
            # one frame per launch both ways: nothing to compare
            "batching_faster": None if perb is None or g == 1
            else perb < per1,
            **served, "launches": launches, "expected_launches": want}


def latency_point(n, up, *, dev, rng, geo=FULL):
    """One NxN RGBA frame -> 4x through kernel C, one frame a launch
    against :func:`microbatch_for` frames in one launch (each equal to its
    own launch), per frame at the program-output boundary
    (``suite.bench_program_output``), and served through ``up`` (a
    ``serving.Upscaler`` at 4x; :func:`served_point`). Returns (row,
    pending)."""
    s = LATENCY_SCALE
    cache: dict = {}
    fn = lambda x: mxu.resize_mxu(x, s, METHOD, weight_cache=cache)
    img = rng.integers(0, 256, (n, n, 4), dtype=np.uint8)
    x = torch.from_numpy(img).to(dev)
    plan_ms = plan_build_ms(lambda: fn(x), dev)
    got, single = counted(lambda: fn(x))
    cases = [suite.parity_case(img, s, got)]
    del got
    g = microbatch_for(n, up.MICROBATCH_TARGET_PX, geo.max_group)
    batch = torch.from_numpy(rng.integers(0, 256, (g, n, n, 4),
                                          dtype=np.uint8)).to(dev)
    gotb, batched = counted(lambda: fn(batch))
    equal = all(torch.equal(gotb[i], fn(batch[i])) for i in range(g))
    del gotb
    per1 = perb = None
    if _timed(dev):
        # the loop grows to the outputs' byte cap (~1.2 GB), not to the
        # suite's 64 launches: small frames need long loops
        per1 = suite.bench_program_output(fn, x, max_k=100_000)
        perb = suite.bench_program_output(fn, batch, max_k=100_000) / g
    frames = list(rng.integers(0, 256, (served_frames(g, geo), n, n, 4),
                               dtype=np.uint8))
    served, s_launches, s_want = served_point(up, frames, g, dev=dev,
                                              learned=False)
    row = _curve_row(n, s, g, per1, perb, served,
                     {"single": single, "batched": batched, **s_launches},
                     {"single": expected(resize_mxu=1),
                      "batched": expected(resize_mxu=1), **s_want})
    row.update(served_frames=len(frames), plan_build_ms=plan_ms,
               batched_equal_to_single_launches=equal)
    return row, [(row, cases)]


def _host_u8(out) -> np.ndarray:
    """A serving result as host HWC uint8 (RGBA32 words viewed)."""
    from ..serving import _fetch
    return np.asarray(_fetch(out)).astype(np.int16)


def learned_point(n, up, *, dev, rng, geo=FULL):
    """One NxN RGBA frame -> 4x through ``up`` (a ``ModelUpscaler`` on a
    WeightPredictor checkpoint): ``up(fetch=False)`` (kernel A, then B
    for the RGBA32 words) against ``up.batch(fetch=False)`` of
    :func:`microbatch_for` frames (A once), per frame at the
    program-output boundary, and served (:func:`served_point`). The
    single frame is held to the plain graph tail (``max_u8_delta``), each
    grouped frame to its own single launch (``batched_max_u8_vs_single``);
    the learned contract is ≤1 u8 for both. Returns the row."""
    from ..models.inference import super_resolve
    img = rng.integers(0, 256, (n, n, 4), dtype=np.uint8)
    x = torch.from_numpy(img).to(dev)
    one = lambda t: up(t, fetch=False)
    many = lambda t: up.batch(t, fetch=False)
    plan_ms = plan_build_ms(lambda: one(x), dev)
    got, single = counted(lambda: one(x))
    graph = super_resolve(up.model, up.params, x, tail="graph",
                          **up._kw())
    delta = int(np.abs(_host_u8(got) - _host_u8(graph)).max())
    del got, graph
    g = microbatch_for(n, up.MICROBATCH_TARGET_PX, geo.max_group)
    batch = torch.from_numpy(rng.integers(0, 256, (g, n, n, 4),
                                          dtype=np.uint8)).to(dev)
    gotb, batched = counted(lambda: many(batch))
    hb = _host_u8(gotb)
    worst = max(int(np.abs(hb[i] - _host_u8(one(batch[i]))).max())
                for i in range(g))
    del gotb, hb
    per1 = perb = None
    if _timed(dev):
        per1 = suite.bench_program_output(one, x, max_k=100_000)
        perb = suite.bench_program_output(many, batch, max_k=100_000) / g
    frames = list(rng.integers(0, 256, (served_frames(g, geo), n, n, 4),
                               dtype=np.uint8))
    served, s_launches, s_want = served_point(up, frames, g, dev=dev,
                                              learned=True)
    # on the card a single RGBA frame leaves as RGBA32 words through B
    words = int(dev.type == "cuda")
    row = _curve_row(n, up.scale, g, per1, perb, served,
                     {"single": single, "batched": batched, **s_launches},
                     {"single": expected(packed_tail_fused=1,
                                         interleave_planar_u32=words),
                      "batched": expected(packed_tail_fused=1), **s_want})
    row.update(served_frames=len(frames), plan_build_ms=plan_ms,
               max_u8_delta=delta, batched_max_u8_vs_single=worst)
    return row


def run_latency_curve(*, geo=FULL, dev, card="", emit=None) -> dict:
    """The two latency curves at ``geo``'s sizes, in the JAX script's
    table form (``rows``: kernel C, each single output held to the
    oracle) with the learned table beside it (``learned``), each stamped
    with the threshold ``serving`` now holds and its group target."""
    from ..serving import ModelUpscaler, Upscaler
    rng = np.random.default_rng(0)
    up = Upscaler(scale=LATENCY_SCALE, device=str(dev))
    rows, pending = {}, []
    for n in geo.latency_sizes:
        rows[f"{n}x{n}"], p = latency_point(n, up, dev=dev, rng=rng, geo=geo)
        pending += p
    hold(pending)
    mup = ModelUpscaler(str(ROOT / LEARNED_MODEL), device=str(dev))
    learned = {f"{n}x{n}": learned_point(n, mup, dev=dev, rng=rng, geo=geo)
               for n in geo.learned_sizes}
    for table, rs in (("classical", rows), ("learned", learned)):
        for key, row in rs.items():
            row["card"] = card
            if emit:
                emit({"table": table, "size": key, **row})
    return {"geometry": f"NxN RGBA u8 -> {LATENCY_SCALE}x {METHOD}, kernel "
                        "C (csrc/resize_mxu.cu), program-output boundary; "
                        "served: Upscaler.stream() with fetches",
            "backend": dev.type, "card": card,
            "microbatch_threshold_px": Upscaler.MICROBATCH_THRESHOLD_PX,
            "target_px": Upscaler.MICROBATCH_TARGET_PX, "rows": rows,
            "learned": {
                "geometry": f"NxN RGBA u8 -> {mup.scale}x, ModelUpscaler("
                            f"{LEARNED_MODEL}): kernel A (csrc/"
                            "packed_tail.cu), B (csrc/interleave.cu) on "
                            "single frames, program-output boundary; "
                            "served: ModelUpscaler.stream() with fetches",
                "model": LEARNED_MODEL,
                "microbatch_threshold_px":
                    ModelUpscaler.MICROBATCH_THRESHOLD_PX,
                "target_px": ModelUpscaler.MICROBATCH_TARGET_PX,
                "rows": learned}}


def size_px(size: str) -> int:
    """The pixels of a table's size key ("HxW")."""
    h, w = (int(v) for v in size.split("x"))
    return h * w


def batching_wins(row) -> bool:
    """The serving policy's test at one size of one call: more than one
    frame a launch, and a grouped frame at most :data:`WIN_SLACK` times a
    frame launched alone, both at the program-output boundary and served
    (``stream()`` with its fetches)."""
    return (row["microbatch"] > 1
            and row["batched_ms_per_frame"]
            <= WIN_SLACK * row["single_ms"]
            and row["served_grouped_ms_per_frame"]
            <= WIN_SLACK * row["served_single_ms_per_frame"])


def threshold_from(tables: list) -> int:
    """The ``MICROBATCH_THRESHOLD_PX`` that ``tables`` (one curve's rows
    dict from each of several calls, the same sizes in each) give: the LR
    pixels of the smallest size at which batching did not win in every
    call, or one more than the largest size's if it won at every size."""
    sizes = sorted(tables[0], key=size_px)
    if any(sorted(t, key=size_px) != sizes for t in tables):
        raise ValueError("the calls measured different sizes")
    for size in sizes:
        if not all(batching_wins(t[size]) for t in tables):
            return size_px(size)
    return size_px(sizes[-1]) + 1


def card_curves() -> list:
    """The committed card runs of ``scripts/torch_latency_curve.py``
    (``results_torch/latency_curve_call*.json``), in call order."""
    return [json.loads(p.read_text()) for p in
            sorted(CARD_RESULTS_DIR.glob("latency_curve_call*.json"))]


#: the files a card run's ``source_sha256`` covers: the port and the two
#: measurement scripts that write ``results_torch/``
SOURCE_GLOBS = ("bicubic_interpolation_model_tpu_torch/**/*.py",
                "bicubic_interpolation_model_tpu_torch/csrc/*",
                "scripts/torch_bench_configs.py",
                "scripts/torch_latency_curve.py")


def source_sha256() -> str:
    """SHA-256 of the files :data:`SOURCE_GLOBS` names (each one's path
    from the root, then its bytes, in path order), the lines that set
    ``MICROBATCH_THRESHOLD_PX`` left out: the curves never read them, and
    they are set from the curves afterwards. A checkout that gives a
    committed run's ``source_sha256`` runs the code that measured it."""
    h = hashlib.sha256()
    for path in sorted({p for g in SOURCE_GLOBS for p in ROOT.glob(g)
                        if p.is_file()}):
        data = re.sub(rb"(?m)^ *MICROBATCH_THRESHOLD_PX = .*\n", b"",
                      path.read_bytes())
        h.update(f"{path.relative_to(ROOT).as_posix()}\0{len(data)}\0"
                 .encode())
        h.update(data)
    return h.hexdigest()


def provenance(dev, card: str, commit: str | None = None) -> dict:
    """Where a table was measured: the backend, the card's name and power
    limit (``card``), torch and CUDA, the source revision (``commit``,
    else ``git rev-parse HEAD`` where the checkout has its history), the
    code's :func:`source_sha256` and the UTC date."""
    import datetime
    import subprocess
    if commit is None:
        try:
            out = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT,
                                 capture_output=True, text=True, timeout=30)
            commit = out.stdout.strip() if out.returncode == 0 else None
        except OSError:
            pass
    return {"backend": dev.type, "card": card, "torch": torch.__version__,
            "cuda": torch.version.cuda, "commit": commit or None,
            "source_sha256": source_sha256(),
            "date": datetime.datetime.now(datetime.timezone.utc).strftime(
                "%Y-%m-%dT%H:%M:%SZ")}


#: calls of a traced launch loop
TRACE_CALLS = 1000
#: host ops listed per traced loop, by self time
TRACE_TOP = 8
#: the profiler range around each traced call
TRACE_RANGE = "call"


def trace_summary(events, calls: int, wall_s: float) -> dict:
    """Per call of a loop of ``calls`` calls that took ``wall_s`` on the
    host clock (last call to the fence), from its profiler ``events``
    (``torch.profiler``'s ``events()``): the device ops' summed time
    (``device_ms``, None where the trace holds no device op), its share of
    the loop's wall time (``device_busy_share``; ``device_idle_share`` the
    rest), and the host ops' self time: in all and the :data:`TRACE_TOP`
    largest by name (``host_ops_ms``). The :data:`TRACE_RANGE` range's
    own self time is the host time inside the calls that no op recorded
    (Python, the ctypes call, the plan lookup); its copy on the device
    timeline spans the device ops and is not counted."""
    dev_us, host = 0.0, {}
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CPU:
            host[e.name] = host.get(e.name, 0.0) + e.self_cpu_time_total
        elif e.name != TRACE_RANGE:
            dev_us += e.time_range.end - e.time_range.start
    wall_us = wall_s * 1e6
    top = sorted(host.items(), key=lambda kv: -kv[1])[:TRACE_TOP]
    busy = dev_us / wall_us if dev_us else None
    return {"calls": calls, "wall_ms": wall_us / calls / 1e3,
            "device_ms": dev_us / calls / 1e3 if dev_us else None,
            "device_busy_share": busy,
            "device_idle_share": None if busy is None else 1.0 - busy,
            "host_self_ms": sum(host.values()) / calls / 1e3,
            "host_ops_ms": {k: v / calls / 1e3 for k, v in top}}


def launch_trace(fn, x, calls: int = TRACE_CALLS) -> dict:
    """``calls`` calls of ``fn`` over copies of ``x`` rotated past the L2,
    after a warm call: the loop's host time per call without the profiler
    (``wall_ms_unprofiled``), then the same loop under ``torch.profiler``
    (CPU and CUDA activities), each call in a :data:`TRACE_RANGE` range
    (:func:`trace_summary`)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    inputs = suite._rotated(x)
    fn(inputs[0])
    torch.cuda.synchronize()

    def loop(ranged):
        t0 = time.perf_counter()
        for i in range(calls):
            if ranged:
                with record_function(TRACE_RANGE):
                    fn(inputs[i % len(inputs)])
            else:
                fn(inputs[i % len(inputs)])
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    plain = loop(False)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = loop(True)
    return {"wall_ms_unprofiled": plain / calls * 1e3,
            **trace_summary(prof.events(), calls, wall)}


def run_launch_trace(*, geo=FULL, dev, card="", emit=None) -> dict:
    """:func:`launch_trace` of the c1 frame (256x256 RGBA -> 2x) through
    kernel C one frame per launch (``c1_256_gray_2x``'s ``pallas_mxu``
    candidate) and eight per launch (``c1_256_gray_2x_microbatch8``), with
    the kernels' plans cached as the rows keep them. On the CPU each runs
    once and nothing is traced."""
    h, w, s = geo.configs["c1_256_gray_2x"]
    single = suite._resize_for_impl("pallas_mxu", s, METHOD, {})
    loops = {"c1_256_gray_2x pallas_mxu": (
                 single, torch.from_numpy(suite._make_input(h, w)).to(dev)),
             "c1_256_gray_2x_microbatch8": (
                 microbatch_fn(s, {}),
                 torch.from_numpy(microbatch_frames(geo)).to(dev))}
    rows = {}
    for key, (fn, x) in loops.items():
        _, launches = counted(lambda: fn(x))
        row = launch_trace(fn, x) if _timed(dev) else {"calls": 1}
        row.update(launches=launches,
                   expected_launches=expected(resize_mxu=1), card=card)
        rows[key] = row
        if emit:
            emit({"loop": key, **row})
    return {"backend": dev.type, "card": card, "loops": rows}


def failures(rows: dict, on_card: bool) -> list:
    """What fails in ``rows`` (a table's rows): a delta above 1 u8 (of a
    single-frame row's every candidate too), a batch or stream frame
    unequal to its own launch (more than 1 u8 from it for a learned
    frame), and on the card launches other than expected."""
    bad = []
    for key, row in rows.items():
        if row.get("max_u8_delta") is None or row["max_u8_delta"] > 1:
            bad.append(f"{key}: max_u8_delta {row.get('max_u8_delta')}")
        for k in ("equal_to_single_launches",
                  "batched_equal_to_single_launches"):
            if row.get(k) is False:
                bad.append(f"{key}: {k} is False")
        if row.get("batched_max_u8_vs_single", 0) > 1:
            bad.append(f"{key}: batched_max_u8_vs_single "
                       f"{row['batched_max_u8_vs_single']}")
        subs = (row["candidates"].values() if "candidates" in row
                else [row])
        for sub in subs:
            if "candidates" in row and sub["max_u8_delta"] > 1:
                bad.append(f"{key} {sub['impl']}: max_u8_delta "
                           f"{sub['max_u8_delta']}")
            if on_card and sub["launches"] != sub["expected_launches"]:
                bad.append(f"{key} {sub.get('impl', '')}: launches "
                           f"{sub['launches']}, expected "
                           f"{sub['expected_launches']}")
    return bad


def write_results(name: str, table: dict) -> pathlib.Path:
    """``table`` as ``build/results/<name>.json``; says where."""
    RESULTS_DIR.mkdir(parents=True, exist_ok=True)
    path = RESULTS_DIR / f"{name}.json"
    path.write_text(json.dumps(table, indent=1))
    print(f"wrote build/results/{path.name} ({table.get('card')})",
          flush=True)
    return path
