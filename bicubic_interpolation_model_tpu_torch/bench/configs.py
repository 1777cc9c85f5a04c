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
- the latency curve (:func:`latency_point`): NxN RGBA -> 4x through C,
  single and micro-batched, at the program-output boundary.

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
import json
import pathlib
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
METHOD = "bicubic"

RESULTS_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "results"


@dataclasses.dataclass(frozen=True)
class Geometry:
    """The shapes a table runs at."""
    configs: dict
    mixed_batch: tuple
    mixed_buckets: tuple
    mixed_sizes: tuple
    stream_frames: int
    latency_sizes: tuple


FULL = Geometry(CONFIGS, MIXED_BATCH, MIXED_BUCKETS, MIXED_SIZES,
                STREAM_FRAMES, LATENCY_SIZES)
#: the same rows at a small size, for the plain versions on the CPU
SMALL = Geometry(
    {"c1_256_gray_2x": (16, 16, 2), "c2_512_rgb_4x": (16, 24, 4),
     "c4_4k_4x": (27, 48, 4), "c5_1080p_2x_stream": (18, 32, 2)},
    (7, 24, 40, 4), ((2, 3), (3, 2), (4, 2)),
    ((24, 40), (22, 37), (26, 35), (20, 33)), 4, (8, 16, 24))

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


def microbatch_for(n: int, threshold: int) -> int:
    """Frames per launch for NxN frames: ``latency_curve.py``'s rule,
    about 4 x ``threshold`` pixels per launch, 1 to 64 frames."""
    return min(64, max(1, int(round(threshold * 4 / (n * n)))))


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


def latency_point(n, threshold, *, dev, rng, cache=None):
    """One NxN RGBA frame -> 4x through kernel C, single and
    micro-batched (:func:`microbatch_for` frames in one launch, each equal
    to its own launch), per frame at the program-output boundary
    (``suite.bench_program_output``). ``batching_faster`` is None where
    the rule gives one frame per launch. Returns (row, pending)."""
    s = LATENCY_SCALE
    cache = {} if cache is None else cache
    fn = lambda x: mxu.resize_mxu(x, s, METHOD, weight_cache=cache)
    img = rng.integers(0, 256, (n, n, 4), dtype=np.uint8)
    x = torch.from_numpy(img).to(dev)
    plan_ms = plan_build_ms(lambda: fn(x), dev)
    got, single = counted(lambda: fn(x))
    cases = [suite.parity_case(img, s, got)]
    del got
    b = microbatch_for(n, threshold)
    batch = torch.from_numpy(rng.integers(0, 256, (b, n, n, 4),
                                          dtype=np.uint8)).to(dev)
    gotb, batched = counted(lambda: fn(batch))
    equal = all(torch.equal(gotb[i], fn(batch[i])) for i in range(b))
    del gotb
    per1 = perb = None
    if _timed(dev):
        # the loop grows to the outputs' byte cap (~1.2 GB), not to the
        # suite's 64 launches: small frames need long loops
        per1 = suite.bench_program_output(fn, x, max_k=100_000)
        perb = suite.bench_program_output(fn, batch, max_k=100_000) / b
    out_px = (n * s) ** 2
    row = {"single_ms": to_ms(per1), "single_gpix_s": _gpix(out_px, per1),
           "microbatch": b, "batched_ms_per_frame": to_ms(perb),
           "batched_gpix_s": _gpix(out_px, perb),
           "policy_batches": n * n < threshold,
           # one frame per launch both ways: nothing to compare
           "batching_faster": None if perb is None or b == 1
           else perb < per1,
           "plan_build_ms": plan_ms,
           "launches": {"single": single, "batched": batched},
           "expected_launches": {"single": expected(resize_mxu=1),
                                 "batched": expected(resize_mxu=1)},
           "batched_equal_to_single_launches": equal}
    return row, [(row, cases)]


def run_latency_curve(threshold, *, geo=FULL, dev, card="",
                      emit=None) -> dict:
    """:func:`latency_point` at each of ``geo.latency_sizes``, held to the
    oracle, in the JAX script's table form; ``threshold`` is the serving
    policy's ``MICROBATCH_THRESHOLD_PX``."""
    rng = np.random.default_rng(0)
    cache: dict = {}
    rows, pending = {}, []
    for n in geo.latency_sizes:
        rows[f"{n}x{n}"], p = latency_point(n, threshold, dev=dev, rng=rng,
                                            cache=cache)
        pending += p
    hold(pending)
    for key, row in rows.items():
        row["card"] = card
        if emit:
            emit({"size": key, **row})
    return {"geometry": f"NxN RGBA u8 -> {LATENCY_SCALE}x {METHOD}, kernel "
                        "C (csrc/resize_mxu.cu), program-output boundary",
            "backend": dev.type, "card": card,
            "microbatch_threshold_px": threshold, "rows": rows}


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
    unequal to its own launch, and on the card launches other than
    expected."""
    bad = []
    for key, row in rows.items():
        if row.get("max_u8_delta") is None or row["max_u8_delta"] > 1:
            bad.append(f"{key}: max_u8_delta {row.get('max_u8_delta')}")
        for k in ("equal_to_single_launches",
                  "batched_equal_to_single_launches"):
            if row.get(k) is False:
                bad.append(f"{key}: {k} is False")
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
