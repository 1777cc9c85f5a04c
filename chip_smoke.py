"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from
``bicubic_interpolation_model_tpu_torch/csrc``, holds each against its plain
PyTorch version on the card, serves frames through the port's
``ModelUpscaler`` (learned SR on the committed WeightPredictor checkpoints
at 348x510 -> 4x RGBA), through its classical ``Upscaler`` (1080x1920 RGBA
-> 4x, 2.5x and the forced phase route), through
``Upscaler(method="adaptive")`` and ``resize(impl="pallas")`` (1080x1920
RGBA -> 4x, and a gray 1080x1920 frame through kernel E) and through the
band- and batch-sharded paths of ``parallel/`` on meshes of 2 and 4 bands on the one card (learned at 348x510, classical
and adaptive at 1080x1920, a batch of 8 frames), checks launch counts and
outputs, and times the kernels, their plain versions and the served
frames. Then it serves the five direct-regression checkpoints
(``model/espcn_*``, ``esrgan_*``, ``srresnet_tpu``: cuDNN convs, no TPU
kernel on that path) through ``ModelUpscaler`` at 348x510 RGBA -> 1392x2040
RGB, holds each against its own float64 run on a crop, and scores thirteen
rebuilds of a synthetic frame with the port's ``evaluation.metrics``.
Then the port's bench (``bench/suite.headline`` at 1080x1920 RGBA -> 4x
through kernels C and D, held to the port's float64 oracle) and its CLI
(all eleven subcommands in-process on a synthetic workspace). Last, the
training slice (no TPU kernel lies on it): data generation on a
synthetic 2040x1356 HR frame against the same call on the CPU, the
weight predictor's trainer in patch and image mode (its card step against
the CPU step), the five direct models' and the MLP's trainers, the sharded
steps on a mesh of the card repeated against the unsharded steps, and the
trained checkpoint saved, loaded and served through kernels A and B.
Then the labs: every probe instance of kernels D, E and G
(``bench/labs.py``: one stage cut or replaced) launched once, held to its
plain version and timed beside its full instance. Then the measurement
scripts' paths (the BASELINE configs; both latency curves, classical
through kernel C and learned through kernels A and B, with the serving
policy's decision per size beside the committed ``results_torch/``
calls; per-method throughput) and the serving policy itself:
``stream(microbatch="auto")`` at the largest size each threshold groups,
launching C, and A and B, once a group. Last, the committed card record
(``results_torch/``): each file fresh or stale against this checkout's
``source_sha256``, and its bicubic 1080p -> 4x row of kernel C and its
``wp-1e-3-120`` row of kernel A re-timed beside the committed values.

Each phase prints one JSON line; any failure raises (exit code != 0). The
line before the last lists every ported kernel with its numbers; the last
line is ``{"ok": true, "device": {...}}``. Without a CUDA device, or
without the repository beside it (its import of the port's package
fails), the script fails and prints no result.
Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import io
import itertools
import json
import pathlib
import statistics
import sys
import time

import numpy as np
import torch

from bicubic_interpolation_model_tpu_torch.bench.labs import (
    all_class_frames, card, emit, u8_frames)

ROOT = pathlib.Path(__file__).resolve().parent
GEOMETRIES = [(24, 40, 4), (19, 37, 4), (13, 9, 3), (8, 128, 1),
              (348, 510, 4)]
# ragged for kernels A's and G's 16-pixel and 8-weight MMA tiles
MMA_EDGES = [(17, 23, 4), (1, 1, 3), (2, 130, 2)]
FRAME = (348, 510)                  # LR frame of the 0020 image, 4x -> 1392x2040
HD = (1080, 1920)                   # classical resize frame, 4x -> 4320x7680
METHODS = ("nearest", "bilinear", "bicubic", "lanczos")
SMALL = ((23, 37), (40, 64), (13, 9))
HBM_BYTES_PER_S = 3.35e12           # H100 SXM, NVIDIA data sheet
F32_FLOP_PER_S = 67e12              # H100 SXM f32 outside the tensor cores
TF32_FLOP_PER_S = 495e12            # H100 SXM tensor cores, dense TF32
BF16_FLOP_PER_S = 989e12            # H100 SXM tensor cores, dense bf16


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


def device_ms(fn, n=20, warmup=3, kernel=None):
    """Device time per call from one torch.profiler trace of ``n`` calls
    (host launch cost excluded). With ``kernel`` (a substring of the name
    of the one kernel that ``fn`` launches once per call) it is the mean
    duration of that kernel's events in the trace: the profiler sometimes
    drops an event (cause unknown), and the mean of the launches the trace
    holds is still the time of one launch; a trace with another count than
    ``n`` is reported on stderr. Other device events of ``fn`` (a wrapper's
    own small kernels) are left out. Otherwise it is the summed durations
    of all device events over ``n``. A trace with no device time is taken
    again, at most four times, and then it raises: a host clock's reading
    is never printed under a device time's name."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    # a trace can come back empty (kernel B's once; kernel C's twice in a
    # row on one run, and the third held its launches)
    for attempt in range(5):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        durations = [e.time_range.end - e.time_range.start
                     for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and (kernel is None or kernel in e.name)]
        if sum(durations) > 0:
            break
        print(f"device_ms: trace {attempt + 1} holds no device time"
              f"{' of ' + kernel if kernel else ''}", file=sys.stderr,
              flush=True)
        time.sleep(1.0)
    if sum(durations) <= 0:
        raise RuntimeError("the profiler's trace holds no device time")
    if kernel is None:
        return sum(durations) / 1e3 / n
    if len(durations) != n:
        print(f"device_ms: the trace holds {len(durations)} device events "
              f"of {n} launches; the mean is over those it holds",
              file=sys.stderr, flush=True)
    return sum(durations) / 1e3 / len(durations)


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


def tail_case(h, w, c, dev, seed, batch=1):
    from bicubic_interpolation_model_tpu_torch.models.inference import (
        _tail_operands)
    rng = np.random.default_rng(seed)
    p = wp_tail_params(rng, dev)
    y = torch.as_tensor(rng.normal(0, 0.5, (batch, h, w, 32)).astype(
        np.float32), device=dev)
    lr = torch.as_tensor(rng.integers(0, 256, (batch, h, w, c)).astype(
        np.float32), device=dev)
    ops = _tail_operands(p, 4, "train")
    return (y, lr, p["conv_out"]["kernel"], p["conv_out"]["bias"], *ops)


def ops_bound(nbytes, products, other, bf16):
    """Least time of a kernel that moves ``nbytes``, runs ``products``
    FLOPs of matrix products on the tensor cores (3xTF32, three passes at
    the TF32 rate, on the f32 route; one pass at the bf16 rate on the bf16
    route) and ``other`` FLOPs on the f32 CUDA cores: the largest of the
    three times, each unit at its peak. Returns (ms, "bytes" or
    "operations")."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_mma = (products / BF16_FLOP_PER_S if bf16
             else 3 * products / TF32_FLOP_PER_S) * 1e3
    t_ops = max(t_mma, other / F32_FLOP_PER_S * 1e3)
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def tail_bound(h, w, c, y_bytes):
    """Least time of the fused tail at [h, w, c] (kernel A; y_bytes 4 for
    f32 features, 2 for bf16): bytes (features, pixels, output words
    read/written once) over the HBM rate; the products of the upsample (256
    up-lanes) and of conv_out over the 16 gated up-lanes of each of 9 taps
    x 16 phases (its offset lanes are an in-image flag times a constant per
    tap and phase, so they cost no products per pixel) on the tensor cores;
    the attention dot, tanh (one operation per weight) and the tap apply on
    the f32 CUDA cores (:func:`ops_bound`)."""
    m = h * w
    nbytes = m * 32 * y_bytes + m * c * 4 + m * 16 * 4
    products = 2 * m * (32 * 256 + 16 * 9 * 16 * 16)
    other = m * (2 * 256 + 256 + 2 * 16 * 16 * c)
    return (*ops_bound(nbytes, products, other, y_bytes == 2), nbytes,
            products + other)


def banded_products(b, c, k_row, k_col, kw, th):
    """Kernel F's tensor-core products as launched on ``b`` frames of ``c``
    channels and tiles of ``th`` output rows: FLOPs of the row product (per
    row tile, 16-row slab and n8 tile of kw*c columns, the k8 blocks of the
    slab's range) and of the transposed column product (per column tile,
    16-column slab and channel, over the th/8 n8 tiles of rows of each row
    tile), 2 x 16 x 8 x 8 a block, for u8 frames; and their time at the
    TF32 rate, the row product in 2 passes (a u8 window has no lo part) and
    the column product in 3. Returns (flops, ms)."""
    k_row, k_col = (np.asarray(k.cpu()) for k in (k_row, k_col))
    block = 2 * 16 * 8 * 8
    row = int((k_row[..., 1] - k_row[..., 0]).sum()) * (kw * c // 8) \
        * k_col.shape[0] * block * b
    col = int((k_col[..., 1] - k_col[..., 0]).sum()) * k_row.shape[0] \
        * (th // 8) * c * block * b
    return row + col, (2 * row + 3 * col) / TF32_FLOP_PER_S * 1e3


def resize_bound(b, h, w, c, ho, wo, taps, in_bytes):
    """Least time of a separable resize [b, h, w, c] -> [b, ho, wo, c]:
    bytes (input read once, output written once) over HBM rate, useful f32
    FLOPs (a multiply-add per tap: the row pass over ho x w, the column
    pass over ho x wo) over the f32 peak."""
    nbytes = b * c * in_bytes * (h * w + ho * wo)
    flops = 2 * taps * b * c * (ho * w + ho * wo)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), nbytes, flops


def phase_probe_bound(probe, b, h, w, c, s, taps):
    """Least time of kernel D's probe ``probe`` on u8 [b, h, w, c] at scale
    s (:func:`resize_bound`'s count): ``chw`` the full resize, ``rowonly``
    its row pass alone, ``null`` no FMA (bytes only)."""
    ho, wo = h * s, w * s
    if probe == "chw":
        return resize_bound(b, h, w, c, ho, wo, taps, 1)[:2]
    nbytes = b * c * (h * w + ho * wo)
    flops = 2 * taps * b * c * ho * w if probe == "rowonly" else 0
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def adaptive_bound(b, h, w, c, s, texture_share, probe="full"):
    """Least time of adaptive bicubic [b, h, w, c] u8 -> [b, h*s, w*s, c]:
    bytes (input read once, output written once) over HBM rate, useful f32
    operations over the f32 peak, counted in the factored order (the least
    count known, the one kernel E runs). Per LR pixel the luma (5), the
    25-tap variance (79) and the class (2); per centre variant 16 factors of
    a luma distance (2) and a law (3 for edge and flat, 4 for texture, exp
    counted as one); per (centre variant, row phase) 16 products a = wy*F,
    12 adds of their column sums and 16 multiply-adds per channel; per
    output pixel 4 multiply-adds per channel and for the weight sum and the
    normalise (a reciprocal, a product and the rounding add per channel);
    for texture centres the exemption term (3 adds and a product per
    (variant, row phase); 3 adds, a product and a multiply-add per channel
    and for the sum per output pixel), by this run's share of texture
    centres. A probe of kernel E (``ops/adaptive_fused.PROBES``) counts what
    it keeps: ``law_scratch`` one multiply-add per factor, ``nolaw`` one
    subtract per factor (and the bias per variant), ``law_const`` and
    ``fma_only`` no factor and no product by it, ``fma_only`` and ``noeq``
    no exemption term."""
    n_lr, n_out = b * h * w, b * h * s * w * s
    variants = 4 if s > 1 else 1
    row_phases = 2 * s if s > 1 else 1      # (variant, row phase) pairs
    law = {"full": 2 + 3 + texture_share, "noeq": 2 + 3 + texture_share,
           "law_scratch": 2, "nolaw": 1 + 1 / 16, "law_const": 0,
           "fma_only": 0}[probe]
    products = 0 if probe in ("law_const", "fma_only") else 16
    eq = 0 if probe in ("fma_only", "noeq") else texture_share
    per_lr = (5 + 79 + 2 + variants * 16 * law
              + row_phases * (products + 12 + 32 * c + 4 * eq))
    per_out = 8 * (c + 1) + 1 + 2 * c + eq * (4 + 2 * (c + 1))
    nbytes = n_lr * c + n_out * c
    flops = n_out * per_out + n_lr * per_lr
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), nbytes, flops


def map_case(h, w, c, halo, dev, seed):
    """Kernel G's operands made on the card from a seed: a merged map
    [h(+2), w, 4, 4, 32] (band rows [-1, h+1) with ``halo="rows"``), LR
    pixels [h(+3), w, c], conv_out's kernel and bias."""
    g = torch.Generator(device=dev).manual_seed(seed)
    rows, lr_rows = (h + 2, h + 3) if halo == "rows" else (h, h)
    m = torch.randn((rows, w, 4, 4, 32), generator=g, device=dev) * 0.5
    lr = torch.randint(0, 256, (lr_rows, w, c), generator=g,
                       device=dev).float()
    kout = torch.randn((3, 3, 32, 16), generator=g, device=dev) * 0.05
    bout = torch.randn((16,), generator=g, device=dev) * 0.25
    return m, lr, kout, bout


def map_bound(h, w, c, halo, m_bytes=4, probe="full"):
    """Least time of kernel G on h x w LR pixels (m_bytes 4 for an f32 map,
    2 for bf16): bytes (the merged map, the LR pixels and the output words,
    each moved once) over the HBM rate; conv_out over all 32 lanes of the
    map (its offset lanes are data here), 9 taps x 32 x 16 multiply-adds
    per output phase, on the tensor cores; tanh and the tap apply (16 x 16
    per channel) on the f32 CUDA cores (:func:`ops_bound`). A stage probe
    (``ops/packed_tail.PROBES``) counts what it keeps: ``matmul`` the
    products and a sum of the 16 weights, ``tanh`` also tanh, neither
    reads the LR pixels; ``apply`` tanh and channel 0's apply, reading
    channel 0."""
    rows, lr_rows = (h + 2, h + 3) if halo == "rows" else (h, h)
    lr_c = {"matmul": 0, "tanh": 0, "apply": 1}.get(probe, c)
    nbytes = (rows * w * 512 * m_bytes + lr_rows * w * lr_c * 4
              + h * w * 16 * 4)
    products = 2 * h * w * 16 * 9 * 32 * 16
    other = h * w * {"matmul": 16 * 16, "tanh": 256 + 16 * 16,
                     "apply": 256 + 2 * 16 * 16}.get(
                         probe, 256 + 2 * 16 * 16 * c)
    return (*ops_bound(nbytes, products, other, m_bytes == 2), nbytes,
            products + other)


def check_kernel_g(pt, dev, emit_fn):
    """Kernel G against its plain version on the card: single frames
    (``halo="zero"``, some ragged for its MMA tiles) and bands of real rows
    (``halo="rows"``: 87 and 174 rows of a 348x510 frame, ragged small
    bands of 1-11 rows); f32, bf16 maps, opaque alpha and the three
    layouts. Returns the largest f32 deviation."""
    worst = 0
    cases = ([(h, w, c, "zero") for h, w, c in GEOMETRIES + MMA_EDGES]
             + [(87, 510, 4, "rows"), (174, 510, 4, "rows"),
                (11, 21, 3, "rows"), (5, 9, 1, "rows"), (1, 23, 4, "rows"),
                (3, 130, 2, "rows")])
    for i, (h, w, c, halo) in enumerate(cases):
        m, lr, kout, bout = map_case(h, w, c, halo, dev, 2000 + i)
        run = lambda mm, ll, **kw: pt.packed_tail(mm, ll, kout, bout,
                                                  halo=halo, **kw)
        ref = lambda mm, ll, **kw: pt.packed_tail_reference(
            mm, ll, kout, bout, halo=halo, **kw).view(torch.uint8)
        got = run(m, lr, layout="planar")
        torch.cuda.synchronize()
        mx, share = diff_u8(got.view(torch.uint8), ref(m, lr))
        std = float(got.view(torch.uint8).float().std())
        mb = m.to(torch.bfloat16)
        mxb, shareb = diff_u8(run(mb, lr, layout="planar").view(torch.uint8),
                              ref(mb, lr))
        hwc = run(m, lr)
        forms = torch.equal(pt.unpack_planar(got, h, w, 4, c), hwc)
        res = {"phase": "kernel_g", "geometry": [h, w, c], "halo": halo,
               "f32_max": mx, "f32_share": share, "std": round(std, 3),
               "bf16_max": mxb, "bf16_share": shareb}
        ok = mx <= 1 and share < 1e-3 and std > 0 and mxb <= 2
        if c == 4:
            words = run(m, lr, layout="hwc32")
            forms = forms and torch.equal(
                words.contiguous().view(torch.uint8).reshape(hwc.shape), hwc)
            olr = lr.clone()
            olr[..., 3] = 255.0
            mxo, _ = diff_u8(run(m, olr, layout="planar", opaque_alpha=True)
                             .view(torch.uint8), ref(m, olr,
                                                     opaque_alpha=True))
            res["opaque_alpha_max"] = mxo
            ok = ok and mxo <= 1
        res["layouts_agree"] = forms
        emit_fn(res)
        if not (ok and forms):
            raise AssertionError(f"kernel G disagrees with its plain "
                                 f"version: {res}")
        worst = max(worst, mx)
    return worst


def check_kernel_e(adf, ilv, dev, emit_fn):
    """Kernel E against its plain version (f32 and float64) on the card,
    over all-class frames; returns the largest deviation."""
    from bicubic_interpolation_model_tpu_torch.ops.adaptive import (
        luma_bt709, region_classes)
    fused = adf.adaptive_resize_fused
    worst = 0
    for s in (1, 2, 3, 4):
        res = {"phase": "kernel_e", "scale": s, "channels": [1, 2, 3, 4],
               "cases": 0, "max": 0,
               "share": 0.0, "f64_max": 0, "f64_share": 0.0,
               "class_diff_share": 0.0, "pixels_texture_flat_edge": [0, 0, 0]}
        # one stream for 3 and 4 channels, another for 1 and 2
        rng34, rng12 = (np.random.default_rng(500 + s),
                        np.random.default_rng(600 + s))
        for (h, w), c in itertools.product(((13, 11), (8, 40), (24, 70)),
                                           (1, 2, 3, 4)):
            rng = rng34 if c > 2 else rng12
            img = torch.from_numpy(all_class_frames(rng, 3, h, w, c)).to(dev)
            cache = {}
            cls = torch.empty((3, h, w), dtype=torch.uint8, device=dev)
            got = fused(img, s, weight_cache=cache, classes_out=cls)
            torch.cuda.synchronize()
            wts = next(iter(cache.values()))
            want_cls = region_classes(luma_bt709(img.float()))
            cdiff = float((cls != want_cls).double().mean())
            mx, share = diff_u8(got, adf.adaptive_resize_reference(
                img, *wts, s))
            mx64, share64 = diff_u8(got, adf.adaptive_resize_reference(
                img, *wts, s, dtype=torch.float64))
            singles = all(torch.equal(got[i], fused(img[i], s))
                          for i in range(3))
            planar = fused(img, s, layout="planar")
            forms = torch.equal(adf.unpack_planar(planar, h, w, s, c), got)
            if c < 4:   # the planar words' bytes above the C channels: 0
                forms = forms and not bool(planar.view(torch.uint8).reshape(
                    -1, 4)[:, c:].any())
            else:
                words = fused(img[0], s, layout="hwc32")
                opq = img.clone()
                opq[..., 3] = 255
                forms = (forms and torch.equal(
                    words.view(torch.uint8).reshape(got[0].shape), got[0])
                    and torch.equal(
                        ilv.interleave_planar_u32(planar[0]).view(torch.uint8),
                        words.view(torch.uint8))
                    and torch.equal(fused(opq, s, opaque_alpha=True),
                                    fused(opq, s)))
            ok = (mx <= 1 and share < 1e-3 and mx64 <= 1 and share64 < 1e-3
                  and cdiff == 0.0 and singles and forms
                  and float(got.float().std()) > 0)
            if not ok:
                raise AssertionError(
                    f"kernel E disagrees with its plain version: x{s} "
                    f"{h}x{w}x{c}: {mx} LSB, share {share}, f64 {mx64} / "
                    f"{share64}, classes differing {cdiff}, batch=singles "
                    f"{singles}, layouts and opaque alpha agree {forms}")
            res["cases"] += 1
            res["max"] = max(res["max"], mx)
            res["share"] = max(res["share"], share)
            res["f64_max"] = max(res["f64_max"], mx64)
            res["f64_share"] = max(res["f64_share"], share64)
            res["class_diff_share"] = max(res["class_diff_share"], cdiff)
            for k in range(3):
                res["pixels_texture_flat_edge"][k] += int((cls == k).sum())
        emit_fn(res)
        worst = max(worst, res["max"])
    # the output tile is staged in passes where it outgrows shared memory
    # (scales above 14); a bound on the staged phases makes small scales
    # take the same passes, which must not change a byte
    res = {"phase": "kernel_e_passes", "cases": 0, "max": 0, "share": 0.0}
    rng34, rng12 = np.random.default_rng(505), np.random.default_rng(605)
    for c, (s, stages) in itertools.product(
            (1, 2, 3, 4), ((15, (0,)), (17, (0, 40, 5)), (5, (0, 12, 3, 1)),
                     (4, (0, 8, 2)))):
        rng = rng34 if c > 2 else rng12
        img = torch.from_numpy(all_class_frames(rng, 2, 19, 41, c)).to(dev)
        cache = {}
        outs = [fused(img, s, weight_cache=cache, stage_phases=st)
                for st in stages]
        mx, share = diff_u8(outs[0], adf.adaptive_resize_reference(
            img, *next(iter(cache.values())), s))
        same = all(torch.equal(o, outs[0]) for o in outs[1:]) and all(
            torch.equal(adf.unpack_planar(fused(
                img, s, layout="planar", stage_phases=st), 19, 41, s, c),
                outs[0]) for st in stages)
        if mx > 1 or share >= 1e-3 or not same:
            raise AssertionError(
                f"kernel E in passes: x{s} 19x41x{c}: {mx} LSB, share "
                f"{share}, every staging equal {same}")
        res["cases"] += len(stages)
        res["max"] = max(res["max"], mx)
        res["share"] = max(res["share"], share)
    emit_fn(res)
    return max(worst, res["max"])


def e_vs_float64(adf, got, img, cls, wts, s):
    """Kernel E's frame ``got`` [H*s, W*s, C] of the one frame ``img``
    [1, H, W, C] (classes ``cls`` [1, H, W] as the kernel computed them)
    against its float64 plain version. In f32 the variance sq - s*s/25
    cancels (sums reach 1.6e6), so a centre within that error of a
    threshold takes another class in float64 and with it another law for
    its whole pixel. Those LR cells (any of their four candidate centres
    flipped) are left out; returns (max, share) elsewhere, the max in the
    cells left out, and the share of LR pixels whose class flips."""
    from bicubic_interpolation_model_tpu_torch.ops.adaptive import (
        luma_bt709, region_classes)
    flip = cls != region_classes(luma_bt709(img.double()))
    hit = flip.clone()
    hit[:, :-1] |= flip[:, 1:]
    hit[:, :, :-1] |= flip[:, :, 1:]
    hit[:, :-1, :-1] |= flip[:, 1:, 1:]
    keep = ~hit[0].repeat_interleave(s, 0).repeat_interleave(s, 1)
    d64 = (got.to(torch.int16) - adf.adaptive_resize_reference(
        img, *wts, s, dtype=torch.float64)[0].to(torch.int16)).abs()
    flipped_max = int(d64[~keep].max()) if bool(hit.any()) else 0
    return ((int(d64[keep].max()), float((d64[keep] != 0).double().mean())),
            flipped_max, float(flip.double().mean()))


def check_kernel_f(banded, mxu, dev, emit_fn):
    """Kernel F against its plain version (f32 and float64) and against
    kernel C on the card; returns the largest deviation."""
    worst = 0
    for method in METHODS:
        res = {"phase": "kernel_f", "method": method, "cases": 0, "max": 0,
               "share": 0.0, "f64_max": 0, "vs_kernel_c_max": 0,
               "float_err": 0.0}
        rng = np.random.default_rng(600)
        for s in (2, 3, 4):
            for (h, w), c in itertools.product(SMALL + ((40, 70),),
                                               (1, 3, 4)):
                img = torch.from_numpy(u8_frames(rng, 2, h, w, c)).to(dev)
                cache = {}
                got = banded.resize_banded(img, s, method, weight_cache=cache)
                torch.cuda.synchronize()
                b_row, b_colt, left = next(iter(cache.values()))[:3]
                ref = lambda x, **k: banded.resize_banded_reference(
                    x, b_row, b_colt, s, left, **k)
                mx, share = diff_u8(got, ref(img))
                mx64, _ = diff_u8(got, ref(img, dtype=torch.float64))
                mxc, _ = diff_u8(got, mxu.resize_mxu(img, s, method))
                singles = all(torch.equal(got[i], banded.resize_banded(
                    img[i], s, method)) for i in range(2))
                gf = banded.resize_banded(img.float(), s, method)
                ferr = float((gf - ref(img.float())).abs().max())
                ok = (mx <= 1 and share < 1e-2 and mx64 <= 1 and mxc <= 1
                      and singles and float(got.float().std()) > 0
                      and ferr < 1e-3 and (mx == 0 or method != "nearest"))
                if not ok:
                    raise AssertionError(
                        f"kernel F disagrees with its plain version: "
                        f"{method} x{s} {h}x{w}x{c}: {mx} LSB, share "
                        f"{share}, f64 {mx64}, kernel C {mxc}, "
                        f"batch=singles {singles}, float {ferr}")
                res["cases"] += 1
                res["max"] = max(res["max"], mx)
                res["share"] = max(res["share"], share)
                res["f64_max"] = max(res["f64_max"], mx64)
                res["vs_kernel_c_max"] = max(res["vs_kernel_c_max"], mxc)
                res["float_err"] = max(res["float_err"], ferr)
        emit_fn(res)
        worst = max(worst, res["max"])
    return worst


def check_kernel_c(mxu, dev, emit_fn):
    """Kernel C against its plain version (f32 and float64) on the card."""
    worst = 0
    for method in METHODS:
        res = {"phase": "kernel_c", "method": method, "cases": 0, "max": 0,
               "share": 0.0, "f64_max": 0, "float_err": 0.0}
        rng = np.random.default_rng(300)
        for scale in (4, 2, 3, 1.5, 2.5, 1.25):
            for (h, w), c in itertools.product(SMALL, (1, 2, 3, 4)):
                img = torch.from_numpy(u8_frames(rng, 3, h, w, c)).to(dev)
                cache = {}
                got = mxu.resize_mxu(img, scale, method, weight_cache=cache)
                torch.cuda.synchronize()
                plans = next(iter(cache.values()))[:4]
                mx, share = diff_u8(got, mxu.resize_mxu_reference(img, *plans))
                mx64, _ = diff_u8(got, mxu.resize_mxu_reference(
                    img, *plans, dtype=torch.float64))
                singles = all(torch.equal(got[i], mxu.resize_mxu(
                    img[i], scale, method)) for i in range(3))
                flat = mxu.resize_mxu(img, scale, method, layout="flat")
                view = mxu.flat_to_hwc_np(flat[0].cpu().numpy(),
                                          got.shape[1], got.shape[2], c)
                gf = mxu.resize_mxu(img.float(), scale, method)
                ferr = float((gf - mxu.resize_mxu_reference(
                    img.float(), *plans)).abs().max())
                ok = (mx <= 1 and share < 1e-2 and mx64 <= 1 and singles
                      and float(got.float().std()) > 0 and ferr < 1e-3
                      and np.array_equal(view, got[0].cpu().numpy())
                      and (mx == 0 or method != "nearest"))
                if not ok:
                    raise AssertionError(
                        f"kernel C disagrees with its plain version: "
                        f"{method} x{scale} {h}x{w}x{c}: {mx} LSB, share "
                        f"{share}, f64 {mx64}, batch=singles {singles}, "
                        f"float {ferr}")
                res["cases"] += 1
                res["max"] = max(res["max"], mx)
                res["share"] = max(res["share"], share)
                res["f64_max"] = max(res["f64_max"], mx64)
                res["float_err"] = max(res["float_err"], ferr)
        emit_fn(res)
        worst = max(worst, res["max"])
    return worst


def check_kernel_d(phase, dev, emit_fn):
    """Kernel D against its plain version (f32 and float64) on the card."""
    worst = 0
    for method, lanczos_a in [(m, 3) for m in METHODS] + [("lanczos", 2)]:
        res = {"phase": "kernel_d", "method": method, "lanczos_a": lanczos_a,
               "cases": 0, "max": 0, "share": 0.0, "f64_max": 0,
               "float_err": 0.0}
        rng = np.random.default_rng(400)
        for s in (2, 3, 4):
            for (h, w), c in itertools.product(SMALL, (1, 2, 3, 4)):
                img = torch.from_numpy(u8_frames(rng, 3, h, w, c)).to(dev)
                cache = {}
                kw = dict(lanczos_a=lanczos_a, weight_cache=cache)
                got = phase.resize_phase(img, s, method, **kw)
                torch.cuda.synchronize()
                wrow, wcol, taps, left = next(iter(cache.values()))[:4]
                ref = lambda x, **k: phase.resize_phase_reference(
                    x, wrow, wcol, s, taps, left, **k)
                mx, share = diff_u8(got, ref(img))
                mx64, _ = diff_u8(got, ref(img, dtype=torch.float64))
                planar = phase.resize_phase(img, s, method, layout="planar",
                                            **kw)
                same = torch.equal(
                    phase.interleave_planar(planar, h, w, s, c), got)
                singles = all(torch.equal(got[i], phase.resize_phase(
                    img[i], s, method, **kw)) for i in range(3))
                gf = phase.resize_phase(img.float(), s, method, **kw)
                ferr = float((gf - ref(img.float())).abs().max())
                ok = (mx <= 1 and share < 1e-2 and mx64 <= 1 and same
                      and singles and float(got.float().std()) > 0
                      and ferr < 1e-3 and (mx == 0 or method != "nearest"))
                if not ok:
                    raise AssertionError(
                        f"kernel D disagrees with its plain version: "
                        f"{method} a={lanczos_a} x{s} {h}x{w}x{c}: {mx} LSB, "
                        f"share {share}, f64 {mx64}, planar=hwc {same}, "
                        f"batch=singles {singles}, float {ferr}")
                res["cases"] += 1
                res["max"] = max(res["max"], mx)
                res["share"] = max(res["share"], share)
                res["f64_max"] = max(res["f64_max"], mx64)
                res["float_err"] = max(res["float_err"], ferr)
        emit_fn(res)
        worst = max(worst, res["max"])
    return worst


def profile_served_frames(up, frame, n, named, ops=None):
    """Device time by kernel name and the device's busy share over ``n``
    served frames (the upscaler's ``__call__`` with the host fetch), from
    one torch.profiler trace. ``named``: result key -> substring of the
    trace's kernel names whose time it sums; ``ops``: result key -> name of
    a CPU op (``aten::cudnn_convolution``) whose launched kernels' device
    time it sums."""
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("serve"):
            for _ in range(n):
                up(frame)
        torch.cuda.synchronize()
    events = prof.events()
    window = [e for e in events if e.name == "serve"][0].time_range
    # user annotations (an optimizer's step range) are no device work
    dev = [e for e in events if e.name != "serve"
           and e.device_type == torch.autograd.DeviceType.CUDA
           and not e.is_user_annotation]
    if not dev:
        raise RuntimeError("the profiler's trace holds no device time")
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
    total = lambda key: sum(v for k, v in by_name.items() if key in k)
    # a CPU op's device time: the kernels it launched, linked by the trace
    op_time = lambda op: sum(
        e.device_time_total if hasattr(e, "device_time_total")
        else e.cuda_time_total for e in events if e.name == op)
    by_op = {key: op_time(op) / 1e3 / n for key, op in (ops or {}).items()}
    return {"frames": n, "host_ms_per_frame": span / 1e3 / n,
            "device_busy_ms_per_frame": busy / 1e3 / n,
            "device_idle_share": 1.0 - busy / span,
            **{key: total(sub) / 1e3 / n for key, sub in named.items()},
            **by_op,
            "device_ms_per_frame_by_kernel": {
                k[:80]: v / 1e3 / n for k, v in top}}


DIRECT = ("espcn_medium", "espcn_thick", "srresnet_tpu", "esrgan_lite",
          "esrgan_plus")


def direct_flops(model, h, w):
    """FLOPs (2 per multiply-add) of a direct model's convs on one [h, w]
    RGB frame, counted from the layer shapes: the model runs on meta
    tensors (shapes only) under PyTorch's FLOP counter."""
    from torch.utils.flop_counter import FlopCounterMode
    from bicubic_interpolation_model_tpu_torch.models.layers import tree_map
    meta = tree_map(lambda t: torch.empty(t.shape, device="meta"),
                    model.tree())
    with FlopCounterMode(display=False) as counter:
        model.apply(meta, torch.empty((1, h, w, 3), device="meta"))
    return counter.get_total_flops()


def synthetic_hr(rng, h, w):
    """An RGBA u8 HR frame made from a seed: smooth gradients, hard edges
    (a checkerboard and a disc) and high-frequency texture."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    r = 128 + 90 * np.sin(x / 97.0) * np.cos(y / 131.0)
    g = 255 * x / w * 0.6 + 60 * (((x // 64) + (y // 48)) % 2)
    disc = (x - 0.6 * w) ** 2 + (y - 0.4 * h) ** 2 < (0.25 * h) ** 2
    b = np.where(disc, 210.0, 50.0) + 30 * np.sin(0.9 * x + 0.35 * y) \
        * np.sin(0.7 * y)
    rgb = np.stack([r, g, b], -1) + rng.normal(0, 6, (h, w, 3))
    out = np.full((h, w, 4), 255, np.uint8)
    out[..., :3] = np.clip(np.floor(rgb + 0.5), 0, 255)
    return out


DIV2K_HR = (1356, 2040)              # a DIV2K-sized HR frame (rows, cols)


def wp_flops(b, h, w):
    """FLOPs (2 per multiply-add) of one WeightPredictor forward on a
    [b, h, w] LR batch, counted from the layer shapes on meta tensors."""
    from torch.utils.flop_counter import FlopCounterMode
    from bicubic_interpolation_model_tpu_torch.models.weight_predictor \
        import WeightPredictor
    meta = WeightPredictor().to_empty(device="meta").tree()
    with FlopCounterMode(display=False) as counter:
        WeightPredictor.apply(meta, torch.empty((b, h, w, 4), device="meta"),
                              torch.empty((b, 4 * h, 4 * w, 2),
                                          device="meta"))
    return counter.get_total_flops()


def step_bound(fwd_flops, nbytes):
    """Bound of a train step: 3 x the forward's FLOPs (forward, the
    backward's two products) over the f32 peak, or its bytes over HBM."""
    return max((3 * fwd_flops / F32_FLOP_PER_S * 1e3, "operations"),
               (nbytes / HBM_BYTES_PER_S * 1e3, "bytes"))


def tree_diff(a, b):
    """Max |a - b| over two parameter trees' leaves (any devices)."""
    from bicubic_interpolation_model_tpu_torch.train.trainer import leaves
    return max(float((x.detach().cpu() - y.detach().cpu()).abs().max())
               for x, y in zip(leaves(a), leaves(b)))


def step_agreement(ps, pu):
    """Two trees after one step from the same parameters: the gradients
    each leaf kept (max |g_a - g_b| over the leaf's max |g_b|), the
    parameters against rtol 2e-5 / atol 2e-6 (worst ratio, elements
    outside, and the largest |g_b| among those)."""
    from bicubic_interpolation_model_tpu_torch.train.trainer import leaves
    g_rel, worst, outside, g_out = 0.0, 0.0, 0, 0.0
    for a, b in zip(leaves(ps), leaves(pu)):
        ga, gb = a.grad.detach().double(), b.grad.detach().double()
        g_rel = max(g_rel, float((ga - gb).abs().max()
                                 / gb.abs().max().clamp(min=1e-30)))
        r = (a.detach() - b.detach()).abs() / (2e-6 + 2e-5 * b.detach().abs())
        worst = max(worst, float(r.max()))
        bad = r > 1.0
        outside += int(bad.sum())
        if bad.any():
            g_out = max(g_out, float(gb[bad].abs().max()))
    return {"grads_max_rel_to_leaf_max": g_rel, "params_max_abs":
            tree_diff(ps, pu), "params_worst_over_tolerance": worst,
            "params_outside_tolerance": outside,
            "max_abs_grad_where_outside": g_out,
            "params": sum(t.numel() for t in leaves(pu))}


def bench_path(name_power, zero_counts, read_counts):
    """The port's bench at full width: ``bench.suite.headline`` on a
    1080x1920 RGBA frame -> 4x for each of bench_torch.py's impls (kernel C
    as ``pallas_mxu``, kernel D as ``pallas_phase`` and
    ``pallas_phase_planar``), each held over the full output geometry
    (every 67th row) to the port's float64 oracle, with its launches read
    on its own; then ``check_parity`` of kernel F (``pallas``). Prints
    bench_torch.py's last line and every impl's row (device-only time and
    the served frame with the fetch); raises where an impl errs, reads
    more than 1 u8, or launched another kernel than its own."""
    import bench_torch
    from bicubic_interpolation_model_tpu_torch.bench import suite
    t0 = time.perf_counter()
    results, launches = [], {}
    for impl in bench_torch.IMPLS:
        zero_counts()
        results += suite.headline(impls=(impl,))[1]
        torch.cuda.synchronize()
        launches[impl] = read_counts()
    best = suite.best_passing(results)
    f_delta = suite.check_parity(4, "bicubic", impl="pallas", h=HD[0],
                                 w=HD[1])
    line = bench_torch.last_line(best, results) if best else None
    emit({"phase": "bench", "card": name_power, "frame": [*HD, 4],
          "line": line, "rows": results, "launches": launches,
          "kernel_f_max_u8_delta": f_delta,
          "seconds": time.perf_counter() - t0})
    own = {"pallas_mxu": "resize_mxu", "pallas_phase": "resize_phase",
           "pallas_phase_planar": "resize_phase"}
    wrong = {impl: c for impl, c in launches.items()
             if c[own[impl]] < 1 or any(v for k, v in c.items()
                                        if k != own[impl])}
    bad = bench_torch.failures(results)
    if bad or best is None or f_delta > 1 or wrong \
            or len(results) != len(bench_torch.IMPLS):
        raise AssertionError(f"bench: failed {bad}, launches {wrong}, "
                             f"kernel F {f_delta}")


def cli_path(name_power, zero_counts, read_counts):
    """The port's CLI in-process (``cli.main.main``) in a workspace under
    build/: a seeded synthetic 1392x2040 HR frame, make-lr, sr-all (the
    classical five, model/wp-1e-3-120 and model/espcn_medium, linked into
    the workspace), sr at 2.5x, eval and bench; then on two 512x512 HR
    crops in a second workspace data, validate-data, train (one epoch from
    model/wp-1e-3-120), validate-model, compare-model and train-sr. Every
    exit code must be 0, every rebuilt PNG within 1 u8 of the same method
    served by Upscaler / ModelUpscaler on the same LR, the launches those
    the commands route to, and the CSVs in the reference's schema."""
    import shutil
    from bicubic_interpolation_model_tpu_torch.cli import main as cli
    from bicubic_interpolation_model_tpu_torch.serving import (
        ModelUpscaler, Upscaler)
    from bicubic_interpolation_model_tpu_torch.utils import imageio

    t_all = time.perf_counter()
    work = ROOT / "build" / "chip_smoke_cli"
    shutil.rmtree(work, ignore_errors=True)
    ws, ws2, hr_dir = work / "ws", work / "train_ws", work / "hr512"
    hr = synthetic_hr(np.random.default_rng(50), FRAME[0] * 4, FRAME[1] * 4)
    imageio.save_png(ws / "cp_image" / "hr_images" / "0001.png", hr)
    for name in ("wp-1e-3-120", "espcn_medium"):
        link = ws / "model" / name
        link.parent.mkdir(parents=True, exist_ok=True)
        link.symlink_to(ROOT / "model" / name, target_is_directory=True)
    for i, (r0, c0) in enumerate(((0, 0), (hr.shape[0] - 512,
                                           hr.shape[1] - 512))):
        imageio.save_png(hr_dir / f"{i:04d}.png",
                         hr[r0:r0 + 512, c0:c0 + 512])
    codes, seconds, launches, printed = {}, {}, {}, {}

    def run(name, workspace, *argv, count=False):
        if count:
            zero_counts()
        out = io.StringIO()            # the command's own output
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(out):
                rc = cli.main(["--workspace", str(workspace), *argv]) or 0
        except SystemExit as e:
            rc = e.code if isinstance(e.code, int) else int(e.code is not None)
        torch.cuda.synchronize()
        codes[name], seconds[name] = rc, time.perf_counter() - t0
        printed[name] = out.getvalue()
        if count:
            launches[name] = read_counts()

    run("make-lr", ws, "make-lr", "--image-id", "0001")
    run("sr-all", ws, "sr-all", "--image-id", "0001", count=True)
    run("sr", ws, "sr", "--image-id", "0001", "--method", "bicubic",
        "--scale", "2.5", "--output", str(work / "bicubic_2.5.png"),
        count=True)
    run("eval", ws, "eval")
    run("bench", ws, "bench", "--runs", "2", count=True)
    run("data", ws2, "data", "--hr-dir", str(hr_dir))
    run("validate-data", ws2, "validate-data")
    run("train", ws2, "train", "--epochs", "1", "--resume",
        str(ROOT / "model" / "wp-1e-3-120"))
    wp = str(ws2 / "model" / "wp")
    run("validate-model", ws2, "validate-model", "--model-dir", wp,
        "--split", "train", "--hr-dir", str(hr_dir))
    run("compare-model", ws2, "compare-model", "--model-dir", wp,
        "--split", "train")
    run("train-sr", ws2, "train-sr", "--hr-dir", str(hr_dir), "--epochs",
        "1")

    # each rebuild against the same method served on the same LR
    lr = imageio.load_rgba(ws / "cp_image" / "lr_images" /
                           "0001_downsample.png")
    rebuilt = ws / "cp_image" / "rebuild_hr_images" / "0001"
    served = {m: (f"{m}.png", lambda m=m: Upscaler(scale=4, method=m)(lr))
              for m in ("nearest", "bilinear", "lanczos")}
    served["bicubic"] = ("bicubic_-0.5.png", lambda: Upscaler(scale=4)(lr))
    served["adaptive"] = ("adaptive_bicubic_-0.5.png", lambda: Upscaler(
        scale=4, method="adaptive")(lr))
    served["model"] = ("wp-1e-3-120.png", lambda: ModelUpscaler(
        str(ROOT / "model" / "wp-1e-3-120"), convention="inference")(lr))
    served["espcn_medium"] = ("espcn_medium.png", lambda: ModelUpscaler(
        str(ROOT / "model" / "espcn_medium"))(lr))
    served["sr_2.5"] = (work / "bicubic_2.5.png",
                        lambda: Upscaler(scale=2.5)(lr))
    vs_served = {}
    for m, (png, serve) in served.items():
        got = imageio.load_rgba(rebuilt / png).astype(np.int16)
        want = serve().astype(np.int16)
        if got.shape[:2] != want.shape[:2] or got[::8, ::8].std() == 0:
            raise AssertionError(f"cli {m}: {got.shape} vs {want.shape}")
        vs_served[m] = int(np.abs(got[..., :want.shape[-1]] - want).max())
    perf = sorted(p.relative_to(ws).as_posix()
                  for p in (ws / "cp_performance").glob("*/*.csv"))
    header = "Run,Timestamp,Execution Time (ms),CPU Time (ms),Memory (MB)"
    csv_ok = all((ws / p).read_text().splitlines()[0] == header
                 for p in perf) and len(perf) == 7 and (
        ws / "cp_image" / "metrics_report.csv").read_text().startswith(
        "IMAGE_ID,METHOD,PSNR(dB),SSIM,MSE\n")
    emit({"phase": "cli", "card": name_power, "hr": list(hr.shape),
          "lr": list(lr.shape), "exit_codes": codes, "seconds": seconds,
          "launches": launches, "rebuilt_vs_served_max": vs_served,
          "bench_output": printed["bench"].splitlines(),
          "performance_csvs": perf, "csv_schema_ok": csv_ok,
          "total_s": time.perf_counter() - t_all})
    shutil.rmtree(work, ignore_errors=True)
    la = launches["sr-all"]
    ok = (len(codes) == 11 and not any(codes.values())
          and max(vs_served.values()) <= 1 and csv_ok
          and la["packed_tail_fused"] >= 1 and la["resize_mxu"] >= 4
          and la["adaptive_resize_fused"] >= 1
          and la["interleave_planar_u32"] >= 1
          and la["resize_phase"] == la["resize_banded"] == 0
          and la["packed_tail"] == 0 and launches["sr"]["resize_mxu"] >= 1
          and launches["bench"]["resize_phase"] >= 1
          and launches["bench"]["resize_banded"] >= 1)
    if not ok:
        raise AssertionError(f"cli: codes {codes}, vs served {vs_served}, "
                             f"launches {launches}, csv {csv_ok} {perf}; "
                             f"output: {printed}")


def train_path(dev, name_power, zero_counts, read_counts):
    """The training slice on the card: data generation, the weight
    predictor's trainer in patch and image mode, the five direct models'
    trainer, the MLP trainer, the sharded steps on a mesh of the card
    repeated, and a trained checkpoint served through kernels A and B.
    Each phase prints one line and raises when a check fails."""
    import shutil
    from bicubic_interpolation_model_tpu_torch.data import div2k, validate
    from bicubic_interpolation_model_tpu_torch.models.espcn import MODEL_ZOO
    from bicubic_interpolation_model_tpu_torch.models.inference import (
        super_resolve)
    from bicubic_interpolation_model_tpu_torch.models.layers import (
        empty_module)
    from bicubic_interpolation_model_tpu_torch.models.mlp_predictor import (
        PixelMLP, extract_pixel_features)
    from bicubic_interpolation_model_tpu_torch.models.srresnet_tpu import (
        SRResNetTPU)
    from bicubic_interpolation_model_tpu_torch.models.weight_predictor \
        import WeightPredictor
    from bicubic_interpolation_model_tpu_torch.ops.learned import (
        gt_weight_map)
    from bicubic_interpolation_model_tpu_torch.parallel import (
        train_sharding)
    from bicubic_interpolation_model_tpu_torch.parallel.mesh import Mesh
    from bicubic_interpolation_model_tpu_torch.serving import ModelUpscaler
    from bicubic_interpolation_model_tpu_torch.train import checkpoint
    from bicubic_interpolation_model_tpu_torch.train import direct_trainer
    from bicubic_interpolation_model_tpu_torch.train import mlp_trainer
    from bicubic_interpolation_model_tpu_torch.train import trainer as tr
    from bicubic_interpolation_model_tpu_torch.utils import imageio
    from bicubic_interpolation_model_tpu_torch.utils.profiling import (
        device_memory_stats)

    quiet = lambda *_: None
    work = ROOT / "build" / "chip_smoke_train"
    shutil.rmtree(work, ignore_errors=True)

    # data_path: generate_sample on the card against the same call on the
    # CPU (the LR is the host's float64 downsample in both; the two CPU
    # calls run in two threads, after the card's calls are timed alone),
    # then process_images on two PNGs and validate_dataset
    from concurrent.futures import ThreadPoolExecutor
    hr = synthetic_hr(np.random.default_rng(40), *DIV2K_HR)
    res = {"phase": "data_path", "card": name_power,
           "hr": list(hr.shape)}
    card_out = {}
    for adaptive in (False, True):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card_out[adaptive] = div2k.generate_sample(hr, 4, adaptive=adaptive,
                                                   device=dev)
        torch.cuda.synchronize()
        res["adaptive" if adaptive else "plain"] = {
            "ms_per_frame": (time.perf_counter() - t0) * 1e3}
    with ThreadPoolExecutor(2) as pool:
        cpu_out = dict(zip((False, True), pool.map(
            lambda a: div2k.generate_sample(hr, 4, adaptive=a,
                                            device="cpu"), (False, True))))
    xg = card_out[False][0]
    for adaptive in (False, True):
        key = "adaptive" if adaptive else "plain"
        (xa, og, yg), (xc, oc, yc) = card_out[adaptive], cpu_out[adaptive]
        if adaptive:
            maps = lambda: div2k._adaptive_weights(xg, *DIV2K_HR, 4,
                                                   device=dev)
        else:
            maps = lambda: gt_weight_map(*DIV2K_HR, 4.0, device=dev)
        y_err = float(np.abs(yg - yc).max())
        res[key].update({"weight_map_device_ms": time_ms(maps, runs=5),
                         "x_bit_equal": bool(np.array_equal(xa, xc)),
                         "offsets_bit_equal": bool(np.array_equal(og, oc)),
                         "y_max_abs_err": y_err, "y_shape": list(yg.shape)})
        if not (res[key]["x_bit_equal"] and res[key]["offsets_bit_equal"]
                and y_err <= (1e-5 if adaptive else 1e-6)):
            raise AssertionError(f"data_path {key}: {res[key]}")
    del card_out, cpu_out
    x_lr = xg                                   # [339, 510, 4] / 255
    src = work / "hr"
    ch, cw = min(512, hr.shape[0] // 2), min(768, hr.shape[1] // 2)
    for i, (r0, c0) in enumerate(((0, 0), (hr.shape[0] - ch,
                                          hr.shape[1] - cw))):
        imageio.save_png(src / f"{i:04d}.png", hr[r0:r0 + ch, c0:c0 + cw])
    t0 = time.perf_counter()
    recs = div2k.process_images(src, work / "ds", device=dev, log=quiet)
    res["process_images_s"] = time.perf_counter() - t0
    res["process_images_hr"] = [2, ch, cw, 4]
    reports = validate.validate_dataset(work / "ds" / "train", log=quiet)
    res["validate"] = {r.sample_id: r.ok for r in reports}
    emit(res)
    if len(recs) != 2 or len(reports) != 2 or not all(reports):
        raise AssertionError(f"process_images / validate_dataset: "
                             f"{[r.errors for r in reports]}")

    # train_wp: TrainConfig() defaults on Y-less data (the synthesised
    # patch targets), 20 steps, then timed on one batch
    data = {"synthetic": {"X": x_lr}}
    cfg = tr.TrainConfig()
    trainer = tr.WeightPredictorTrainer(WeightPredictor(), cfg, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = trainer.fit(data, epochs=20, log=quiet)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    losses = [r["loss"] for r in trainer.history]
    batch = next(trainer._synth_patch_batches(
        data, np.random.default_rng(1), trainer.device_targets()))
    tp = tr.trainable(params, dev)
    opt = trainer.optimizer.init(tp)
    torch.cuda.reset_peak_memory_stats()
    step_ms = time_ms(lambda: trainer.step_fn(tp, opt, *batch), runs=20)
    peak = torch.cuda.max_memory_allocated()
    fwd = wp_flops(cfg.batch_size, cfg.patch_lr, cfg.patch_lr)
    nbytes = sum(np.asarray(a).nbytes if not isinstance(a, torch.Tensor)
                 else a.numel() * a.element_size() for a in batch)
    bound, by = step_bound(fwd, nbytes)
    # each profiled step reads its loss on the host, as fit does
    prof = profile_served_frames(
        lambda _: float(trainer.step_fn(tp, opt, *batch)[2]), None, 5, {},
        ops={"cudnn_convolution_ms_per_step": "aten::cudnn_convolution"})
    # the same step on the card and on the CPU from the same parameters
    out = {}
    for label, d in (("card", dev), ("cpu", torch.device("cpu"))):
        pd = tr.trainable(params, d)
        _, _, loss1, _ = trainer.step_fn(pd, trainer.optimizer.init(pd),
                                         *batch)
        out[label] = (float(loss1), pd)
    loss_rel = abs(out["card"][0] - out["cpu"][0]) / out["cpu"][0]
    p_err = tree_diff(out["card"][1], out["cpu"][1])
    emit({"phase": "train_wp", "card": name_power, "config": "TrainConfig()",
          "batch": [cfg.batch_size, cfg.patch_lr, cfg.patch_lr, 4],
          "steps": len(losses), "loss_first": losses[0],
          "loss_last": losses[-1], "losses": losses,
          "fit_host_s": fit_s, "fit_host_ms_per_step_median":
              statistics.median(r["seconds"] for r in trainer.history) * 1e3,
          "step_ms": step_ms, "forward_flops": fwd,
          "mflop_per_lr_px": fwd / (cfg.batch_size * cfg.patch_lr ** 2)
          / 1e6, "step_bytes": nbytes, "bound_ms": bound, "bound_by": by,
          "share_of_bound": bound / step_ms, "peak_device_mb": peak / 2 ** 20,
          "device_idle_share": prof["device_idle_share"], "profile": prof,
          "card_vs_cpu": {"loss_rel": loss_rel, "params_max_abs": p_err},
          "memory": device_memory_stats()})
    if not losses[-1] < losses[0] or loss_rel > 1e-5 or p_err > 1e-6:
        raise AssertionError(f"train_wp: losses {losses[0]} -> "
                             f"{losses[-1]}, card vs cpu {loss_rel} / "
                             f"{p_err}")

    # train_wp_image: image mode on one and on four 339x510 LR frames (the
    # 384x512 bucket), remat off and on
    flips = (x_lr, x_lr[::-1], x_lr[:, ::-1], x_lr[::-1, ::-1])
    image = {"phase": "train_wp_image", "card": name_power,
             "lr": list(x_lr.shape)}
    for nb in (1, 4):
        idata = {f"f{i}": {"X": np.ascontiguousarray(f)}
                 for i, f in enumerate(flips[:nb])}
        first = {}
        for remat in (False, True):
            icfg = tr.TrainConfig(mode="image", image_batch=nb, remat=remat)
            itr = tr.WeightPredictorTrainer(WeightPredictor(), icfg,
                                            device=dev)
            ibatch = next(itr._image_batches(idata))
            ip = tr.trainable(params, dev)
            _, _, l1, _ = itr.step_fn(ip, itr.optimizer.init(ip), *ibatch)
            first[remat] = (float(l1), ip)
            ip = tr.trainable(params, dev)
            iopt = itr.optimizer.init(ip)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ms = time_ms(lambda: itr.step_fn(ip, iopt, *ibatch), runs=5,
                         warmup=1)
            image[f"batch_{nb}_remat_{remat}"] = {
                "step_ms": ms, "batch": list(ibatch[0].shape),
                "peak_device_mb": torch.cuda.max_memory_allocated()
                / 2 ** 20}
            del ibatch, ip, iopt
            torch.cuda.empty_cache()
        r_loss = abs(first[True][0] - first[False][0])
        r_par = tree_diff(first[True][1], first[False][1])
        image[f"batch_{nb}_remat_vs_plain"] = {
            "loss_abs": r_loss, "params_max_abs": r_par,
            "bit_equal": r_loss == 0 and r_par == 0}
        # the segments recompute the same forward: the loss is bit-equal.
        # The parameters keep the looser gate: cuDNN's FP32 weight gradient
        # sums in no fixed order, so the same plain step run twice already
        # differs in the parameters' last bits (scripts/torch_step_memory.py)
        if r_loss != 0 or r_par > 1e-6:
            raise AssertionError(f"remat step differs: {image}")
    hb, wb = image["batch_1_remat_False"]["batch"][1:3]
    image["bound_ms_per_image"], image["bound_by"] = step_bound(
        wp_flops(1, hb, wb), hb * wb * 4 * (4 + 16 * (2 + 16 + 1)))
    peaks = [image[f"batch_4_remat_{r}"]["peak_device_mb"]
             for r in (False, True)]
    image["batch_4_remat_peak_share_of_plain"] = peaks[1] / peaks[0]
    emit(image)
    if not peaks[1] < peaks[0]:
        raise AssertionError(f"remat does not lower the batch-4 peak: "
                             f"{peaks}")

    # train_direct: the five MODEL_ZOO models at their checkpoints' widths,
    # DirectSRConfig defaults with augment, built on the card
    hr_rgba = div2k.align_crop(hr, 4)
    ddata = {"synthetic": {"X": x_lr, "HR": hr_rgba}}
    for name in DIRECT:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = empty_module(lambda: MODEL_ZOO[name](), dev)
        dtr = direct_trainer.DirectSRTrainer(
            model, direct_trainer.DirectSRConfig(augment=True,
                                                 steps_per_epoch=4),
            device=dev)
        dparams = dtr.init_params()
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        dparams = dtr.fit(ddata, params=dparams, epochs=1, log=quiet)
        dcfg = dtr.cfg
        lr_b, hr_b = dtr._batch(ddata, ["synthetic"],
                                np.random.default_rng(2))
        dopt = dtr.optimizer.init(dparams)
        losses_d = []
        step = lambda: losses_d.append(
            dtr.step_fn(dparams, dopt, lr_b, hr_b)[2])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = time_ms(step, runs=3, warmup=1)
        peak = torch.cuda.max_memory_allocated()
        for _ in range(12):
            step()
        fwd = direct_flops(model, dcfg.patch_lr, dcfg.patch_lr) \
            * dcfg.batch_size
        n_params = sum(t.numel() for t in tr.leaves(dparams))
        dbytes = lr_b.nbytes + hr_b.nbytes + n_params * 4 * 2
        bound, by = step_bound(fwd, dbytes)
        res = {"phase": "train_direct", "card": name_power, "model": name,
               "config": "DirectSRConfig(augment=True)",
               "batch": list(lr_b.shape), "params": n_params,
               "init_on_card_s": init_s, "fit_losses": [
                   r["loss"] for r in dtr.history],
               "same_batch_losses": [float(v) for v in losses_d],
               "step_ms": ms, "forward_flops": fwd, "bound_ms": bound,
               "bound_by": by, "share_of_bound": bound / ms,
               "peak_device_mb": peak / 2 ** 20,
               "profile": profile_served_frames(
                   lambda _: float(dtr.step_fn(dparams, dopt, lr_b, hr_b)[2]),
                   None, 2, {}, ops={"cudnn_convolution_ms_per_step":
                                     "aten::cudnn_convolution"})}
        emit(res)
        # Adam's first update moves every weight by about the rate, and the
        # loss on the batch can rise for a step or two before it falls
        curve = res["same_batch_losses"]
        if not np.isfinite(res["fit_losses"] + curve).all() \
                or not curve[-1] < curve[0]:
            raise AssertionError(f"train_direct {name}: {res}")
        del model, dtr, dparams, dopt
        torch.cuda.empty_cache()

    # train_mlp: PixelMLP with model/pixel-mlp's training configuration
    # (scripts/train_mlps.py: SGD 0.03, batch 8192, patience 8) on the
    # per-pixel features of a 256x256 HR crop
    n = min(64, *x_lr.shape[:2])
    crop = torch.from_numpy(np.ascontiguousarray(x_lr[:n, :n])).to(dev)
    feats = extract_pixel_features(crop, 4 * n, 4 * n, 4)
    targs = gt_weight_map(4 * n, 4 * n, 4.0, device=dev).reshape(-1, 16)
    mcfg = mlp_trainer.MLPTrainConfig(learning_rate=0.03, epochs=3,
                                      batch_size=8192, patience=8)
    mparams, mhist = mlp_trainer.train_pixel_mlp(
        PixelMLP(), feats.cpu().numpy(), targs.cpu().numpy(), mcfg,
        log=quiet, device=dev)
    mstep = mlp_trainer.make_mlp_step(PixelMLP(), mcfg.max_norm)
    mopt = tr.sgd(mcfg.learning_rate).init(mparams)
    xb, yb = feats[:8192].contiguous(), targs[:8192].contiguous()
    mms = time_ms(lambda: mstep(mparams, mopt, xb, yb), runs=20)
    mflops = 2 * 8192 * (66 * 64 + 64 * 32 + 32 * 16)
    mbound, mby = step_bound(mflops, xb.numel() * 4 + yb.numel() * 4)
    emit({"phase": "train_mlp", "card": name_power,
          "config": "MLPTrainConfig(learning_rate=0.03, batch_size=8192, "
                    "patience=8)", "samples": int(feats.shape[0]),
          "history": mhist, "step_ms": mms, "bound_ms": mbound,
          "bound_by": mby})
    if not mhist[-1] < mhist[0]:
        raise AssertionError(f"train_mlp: {mhist}")

    # train_sharded: both sharded steps on a data 2 x spatial 2 mesh of the
    # card repeated, against the unsharded steps from the same parameters
    mesh = Mesh([[dev] * 2] * 2, ("data", "spatial"))
    sharded = {"phase": "train_sharded", "card": name_power,
               "mesh": mesh.shape}
    wp = WeightPredictor()
    sstep, sshard, srepl = train_sharding.make_sharded_train_step(wp, mesh)
    up_ = tr.trainable(params, dev)
    _, _, uloss, _ = trainer.step_fn(up_, trainer.optimizer.init(up_),
                                     *batch)
    sp = srepl(params)
    sopt = trainer.optimizer.init(sp)
    sbatch = sshard(*batch)
    _, _, sloss = sstep(sp, sopt, *sbatch)
    cases = {"weight_predictor": (float(sloss), float(uloss),
                                  next(iter(sp.values())), up_)}
    sp2 = srepl(params)
    sopt2 = trainer.optimizer.init(sp2)
    sharded["weight_predictor_step_ms"] = time_ms(
        lambda: sstep(sp2, sopt2, *sbatch), runs=10)
    net = empty_module(lambda: SRResNetTPU(), dev)
    dtr = direct_trainer.DirectSRTrainer(net, device=dev)
    nparams = dtr.init_params()
    lr_b, hr_b = dtr._batch(ddata, ["synthetic"], np.random.default_rng(3))
    un = tr.trainable(nparams, dev)
    _, _, unl, _ = dtr.step_fn(un, dtr.optimizer.init(un), lr_b, hr_b)
    dstep, dshard, drepl = train_sharding.make_sharded_direct_step(net, mesh)
    sn = drepl(nparams)
    dbatch = dshard(lr_b, hr_b)
    _, _, snl = dstep(sn, dtr.optimizer.init(sn), *dbatch)
    cases["srresnet_tpu"] = (float(snl), float(unl), next(iter(sn.values())),
                             un)
    sn2 = drepl(nparams)
    sopt3 = dtr.optimizer.init(sn2)
    sharded["srresnet_tpu_step_ms"] = time_ms(
        lambda: dstep(sn2, sopt3, *dbatch), runs=5, warmup=1)
    sharded["srresnet_tpu_halo_rows"] = train_sharding.receptive_halo(net)
    # equal steps: the loss within 1e-6, each leaf's gradient within 1e-5
    # of its largest, the parameters at rtol 2e-5 / atol 2e-6 except where
    # the gradient is below 10 x Adam's eps (1e-8): there the update
    # g / (|g| + eps) turns the gradients' f32 reordering into a relative
    # change of the update itself
    ok = True
    for key, (ls, lu, ps, pu) in cases.items():
        agree = step_agreement(ps, pu)
        sharded[key] = {"loss_rel": abs(ls - lu) / lu, **agree}
        ok = ok and abs(ls - lu) <= 1e-6 * lu \
            and agree["grads_max_rel_to_leaf_max"] <= 1e-5 \
            and agree["max_abs_grad_where_outside"] < 1e-7
    emit(sharded)
    if not ok:
        raise AssertionError(f"sharded steps differ from unsharded: "
                             f"{sharded}")
    del net, dtr, nparams, un, sn, sn2, sopt3, dbatch
    torch.cuda.empty_cache()

    # trained_serve: train_wp's parameters saved by checkpoint.save, loaded
    # by ModelUpscaler and served through kernels A and B
    ckpt = checkpoint.save(work / "ckpt", params, meta={
        "model": "WeightPredictor", "scale": 4, "epochs": len(losses)})
    up = ModelUpscaler(str(ckpt))
    frame = np.random.default_rng(41).integers(0, 256, FRAME + (4,),
                                               dtype=np.uint8)
    frame[..., 3] = 255
    zero_counts()
    served = up(frame)
    torch.cuda.synchronize()
    counts = read_counts()
    g = super_resolve(up.model, up.params, frame, convention="train",
                      tail="graph")
    e = super_resolve(up.model, up.params, frame, convention="train",
                      exact=True)
    served_dev = torch.from_numpy(served).to(dev)
    vs_graph, vs_exact = diff_u8(served_dev, g), diff_u8(served_dev, e)
    emit({"phase": "trained_serve", "card": name_power,
          "frame": [*FRAME, 4], "launches": counts,
          "vs_graph_max": vs_graph[0], "vs_graph_share": vs_graph[1],
          "vs_exact_max": vs_exact[0],
          "params_equal_saved": tree_diff(up.params, params) == 0.0,
          "std": float(served.astype(np.float32).std())})
    shutil.rmtree(work, ignore_errors=True)
    expect = {k: 0 for k in counts}
    expect.update(packed_tail_fused=1, interleave_planar_u32=1)
    if counts != expect or vs_graph[0] > 1 or vs_graph[1] >= 1e-3 \
            or vs_exact[0] > 2 or served.shape != (FRAME[0] * 4,
                                                    FRAME[1] * 4, 4):
        raise AssertionError(f"trained_serve: {counts} {vs_graph} "
                             f"{vs_exact}")


def labs_path(dev, name_power):
    """The labs phase: every probe instance of kernels D, E and G
    (``bench/labs``) beside its production instance. With the probes'
    counts at 0, each instance launches once at the labs' shapes (D on a
    1080x1920 RGBA frame at 4x, hwc and planar; E on an all-class
    1080x1920 frame at 4x, planar, C = 4 and 1; G on a 348x510 merged map,
    f32 and bf16); every probe's count must then be 1. Each output is held
    to its plain version at the kernel's tolerance, then each instance is
    timed as the seven kernels are (:func:`device_ms` of its kernel
    function, inputs rotated past the L2), and its plain version once by
    CUDA events. Prints one line per lab and returns the kernels line's
    entries of the probe instances."""
    from bicubic_interpolation_model_tpu_torch.bench import labs, suite
    from bicubic_interpolation_model_tpu_torch.ops.adaptive import (
        luma_bt709, region_classes)
    t0 = time.perf_counter()
    rng = np.random.default_rng(41)
    d_in = torch.from_numpy(u8_frames(rng, 1, *HD, 4)).to(dev)
    d_in[..., 3] = 255
    e_frame = all_class_frames(rng, 1, *HD, 4)
    e_in = [torch.from_numpy(e_frame).to(dev),
            torch.from_numpy(e_frame[..., :1].copy()).to(dev)]
    m, lr, kout, bout = map_case(*FRAME, 4, "zero", dev, 43)
    cases = (labs.d_cases(d_in) + labs.e_cases(e_in)
             + labs.g_cases(m, lr, kout, bout))
    labs.zero_counts()
    outs = [case.run(case.x) for case in cases]
    torch.cuda.synchronize()
    counts = labs.read_counts()
    launched = {case.name: case.launches() for case in cases}
    wrong = {f"{k}:{n}": v for k, c in counts.items() for n, v in c.items()
             if v != 1}
    if wrong:
        raise AssertionError(f"labs: probe launches other than one each: "
                             f"{wrong} ({counts})")
    texture = {c: float((region_classes(luma_bt709(x.float())) == 0)
                        .double().mean()) for c, x in ((4, e_in[0]),
                                                       (1, e_in[1]))}
    rows = {}
    for case, got in zip(cases, outs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        ref = case.plain(case.x)
        b.record()
        b.synchronize()
        err, ok = case.check(got, ref)
        if not ok:
            raise AssertionError(f"labs: {case.name} deviates from its "
                                 f"plain version: {err}")
        del ref
        inputs = [(x,) for x in suite._rotated(case.x, max_copies=16)]
        ms = device_ms(rotating(case.run, inputs), kernel=case.symbol)
        del inputs
        c = case.x.shape[-1]
        if case.kernel == "D":
            bound = (resize_bound(1, *HD, 4, HD[0] * 4, HD[1] * 4, 4, 1)[:2]
                     if case.probe == "full"
                     else phase_probe_bound(case.probe, 1, *HD, 4, 4, 4))
        elif case.kernel == "E":
            bound = adaptive_bound(1, *HD, c, 4, texture[c], case.probe)[:2]
        else:
            bound = map_bound(*FRAME, 4, "zero",
                              2 if case.x.dtype == torch.bfloat16 else 4,
                              case.probe)[:2]
        rows[case.name] = {"case": case, "max_abs_err": err, "ms": ms,
                           "plain_ms": a.elapsed_time(b),
                           "bound_ms": bound[0], "bound_by": bound[1]}
    del outs
    for lab in ("kernel_lab", "adaptive_probe_lab", "adaptive_lab",
                "packed_tail_lab"):
        # adaptive_lab's probes stand beside E's full instances too
        mine = {n: r for n, r in rows.items() if r["case"].lab == lab
                or (lab == "adaptive_lab" and r["case"].kernel == "E"
                    and r["case"].probe == "full")}
        emit({"phase": "labs", "lab": lab, "card": name_power,
              "ms": "device_ms: mean device duration of the instance's "
                    "kernel in one trace of 20 launches",
              "instances": {n: {"probe": r["case"].probe, "ms": r["ms"],
                                "max_abs_err": r["max_abs_err"],
                                "plain_ms": r["plain_ms"],
                                "bound_ms": r["bound_ms"]}
                            for n, r in mine.items()}})
    emit({"phase": "labs_done", "probe_launches": counts,
          "texture_share": texture,
          "seconds": time.perf_counter() - t0})
    torch.cuda.empty_cache()
    return [{"name": n, "route": "cuda", "source": r["case"].source,
             "replaces": r["case"].replaces,
             "launches": launched[n],
             "max_abs_err": r["max_abs_err"], "ms": r["ms"],
             "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
             "bound_by": r["bound_by"], "library_ms": None}
            for n, r in rows.items() if r["case"].probe != "full"]


def config_bound(key, row):
    """(bound ms per frame, or per batch for the mixed batch, by what) of
    a configs or latency row: :func:`resize_bound` of its frames at 4
    taps a pass (bicubic)."""
    from bicubic_interpolation_model_tpu_torch.bench import configs as cf
    if key == "c3_batch64_mixed":
        _, h, w, c = row["batch"]
        parts = [resize_bound(n, h, w, c, h * s, w * s, 4, 1)
                 for s, n in row["buckets"]]
        nbytes = sum(pt[2] for pt in parts)
        flops = sum(pt[3] for pt in parts)
    elif key == "c6_mixed_size_stream":
        s = row["scale"]
        parts = [resize_bound(1, h, w, 4, h * s, w * s, 4, 1)
                 for h, w in (map(int, hw.split("x")) for hw in row["sizes"])]
        nbytes = sum(pt[2] for pt in parts) / len(parts)
        flops = sum(pt[3] for pt in parts) / len(parts)
    else:
        if "shape" in row:
            h, w, s = map(int, row["shape"].split("x"))
        else:
            h = w = int(key.split("x")[0])
            s = cf.LATENCY_SCALE
        c = row.get("c", 4)
        _, _, nbytes, flops = resize_bound(1, h, w, c, h * s, w * s, 4, 1)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def brief(row, keys):
    """The keys of ``row`` that a phase line prints, and its launches
    other than 0 (per drive where a row has several)."""
    out = {k: row[k] for k in keys if k in row}
    nonzero = lambda d: {n: v for n, v in d.items() if v}
    ls = row.get("launches")
    if ls is not None:
        out["launches"] = ({m: nonzero(d) for m, d in ls.items()}
                           if isinstance(next(iter(ls.values())), dict)
                           else nonzero(ls))
    return out


def crop_vs_plain(mxu, phase, dev):
    """Every kernel configuration of the configs, latency and rational
    rows on a crop of its seeded input (ragged to the tiles), held to the
    kernel's plain version on the card: (cases, max u8, largest share of
    differing bytes)."""
    from bicubic_interpolation_model_tpu_torch.bench import configs as cf
    from bicubic_interpolation_model_tpu_torch.bench import suite
    cases = []
    for key, (h, w, s) in cf.CONFIGS.items():
        for c in ((4, 1) if key == "c1_256_gray_2x" else (4,)):
            x = suite._make_input(h, w, c)[None, :67, :131]
            cases += [("C", x, s), ("D", x, s)]
    one = suite._make_input(256, 256)[:37, :45]
    cases.append(("C", np.stack([one ^ np.uint8(i) for i in range(8)]), 2))
    batch, o = cf.mixed_batch(), 0
    for s, n in cf.MIXED_BUCKETS:
        cases.append(("D", batch[o:o + n, :37, :45], s))
        o += n
    cases += [("D", f[None, :h // 16 + 3, :w // 16 + 5], 2)
              for f, (h, w) in zip(cf.mixed_size_frames(), cf.MIXED_SIZES)]
    cases += [("C", suite._make_input(n // 4 + 3, n // 4 + 5)[None], 4)
              for n in cf.LATENCY_SIZES[:2]]
    cases += [("C", suite._make_input(61, 131)[None], sc)
              for sc in (1.5, 2.5)]
    worst, share = 0, 0.0
    for kernel, x, s in cases:
        x = torch.from_numpy(np.ascontiguousarray(x)).to(dev)
        cache = {}
        if kernel == "C":
            got = mxu.resize_mxu(x, s, weight_cache=cache)
            ref = mxu.resize_mxu_reference(
                x, *next(iter(cache.values()))[:4])
        else:
            got = phase.resize_phase(x, s, weight_cache=cache)
            wrow, wcol, taps, left = next(iter(cache.values()))[:4]
            ref = phase.resize_phase_reference(x, wrow, wcol, s, taps, left)
        mx, sh = diff_u8(got, ref)
        worst, share = max(worst, mx), max(share, sh)
    return len(cases), worst, share


def latency_curve_phase(dev, name_power, zero_counts, read_counts):
    """``latency_curve``: both curves of ``scripts/torch_latency_curve.py``
    (NxN -> 4x through C, and through ``ModelUpscaler``: A, B), one frame
    a launch and grouped, device and served, with the counts at 0 before
    and read after; per size the policy's decision, this call's reading
    and the committed ``results_torch/`` calls'."""
    from bicubic_interpolation_model_tpu_torch.bench import configs as cf
    from bicubic_interpolation_model_tpu_torch.serving import (
        ModelUpscaler, Upscaler)
    t0 = time.perf_counter()
    zero_counts()
    table = cf.run_latency_curve(dev=dev, card=name_power)
    torch.cuda.synchronize()
    counts = read_counts()
    committed = cf.card_curves()
    curves = {"classical": (table["rows"], Upscaler.MICROBATCH_THRESHOLD_PX,
                            [c["rows"] for c in committed]),
              "learned": (table["learned"]["rows"],
                          ModelUpscaler.MICROBATCH_THRESHOLD_PX,
                          [c["learned"]["rows"] for c in committed])}
    bad, lines = [], {}
    for name, (rows, threshold, kept) in curves.items():
        bad += [f"{name} {b}" for b in cf.failures(rows, True)]
        lines[name] = {}
        for key, row in rows.items():
            line = lines[name][key] = brief(row, (
                "single_ms", "single_gpix_s", "microbatch",
                "batched_ms_per_frame", "batched_gpix_s", "batching_faster",
                "served_grouped_ms_per_frame", "served_single_ms_per_frame",
                "served_grouped_passes_ms_per_frame",
                "served_single_passes_ms_per_frame", "served_grouped_spread",
                "served_single_spread", "max_u8_delta", "batched_max_u8_vs_single",
                "plan_build_ms"))
            if name == "classical":
                line["bound_ms"] = config_bound(key, row)[0]
            # the policy's decision, this call's reading and the committed
            # calls' (a timing disagreement is printed, not failed)
            line["policy_groups"] = cf.size_px(key) < threshold
            line["batching_wins"] = cf.batching_wins(row)
            line["committed_wins"] = all(
                cf.batching_wins(k[key]) for k in kept) if all(
                key in k for k in kept) and kept else None
            line["agrees_with_committed"] = (line["batching_wins"]
                                             == line["committed_wins"])
    emit({"phase": "latency_curve", "card": name_power,
          "microbatch_threshold_px": {
              n: c[1] for n, c in curves.items()},
          "committed_calls": len(committed),
          "threshold_this_call": {
              n: cf.threshold_from([c[0]]) for n, c in curves.items()},
          "rows": lines["classical"], "learned_rows": lines["learned"],
          "launches": counts, "seconds": time.perf_counter() - t0})
    path = ("resize_mxu", "packed_tail_fused", "interleave_planar_u32")
    if bad or any(v for k, v in counts.items() if k not in path) \
            or not all(counts[k] for k in path):
        raise AssertionError(f"latency_curve: {bad}, launches {counts}")



def measurement_paths(dev, name_power, zero_counts, read_counts):
    """The measurement scripts' paths (``bench/configs``,
    ``bench/methods``), each driven with the seven kernels' counts at 0
    and read after: ``configs`` (every BASELINE row at its full geometry,
    3840x2160 RGBA -> 4x through kernels C and D included, each output held
    to the float64 oracle: every 67th row above 4096 rows, every row
    otherwise; launches per row as expected, C and D launched, no other
    kernel), ``latency_curve`` (both curves of
    ``scripts/torch_latency_curve.py``: NxN -> 4x through C and through
    ``ModelUpscaler`` (A, B), one frame a launch and grouped, device and
    served; per size the policy's decision and whether this call agrees
    with the committed ``results_torch/`` calls) and ``method_throughput`` (its ``rational`` and
    ``downsample`` sections, each resize output held to the oracle on the
    frame it times, launches exactly as expected). Then each kernel configuration on a crop
    against its plain version on the card, and one ``fill_`` of the 4K
    output (the store floor). Prints one line per phase."""
    from bicubic_interpolation_model_tpu_torch.bench import configs as cf
    from bicubic_interpolation_model_tpu_torch.bench import methods
    from bicubic_interpolation_model_tpu_torch.ops import mxu, phase
    others = lambda c: {k: v for k, v in c.items()
                        if k not in ("resize_mxu", "resize_phase") and v}
    keys = ("impl", "c", "ms_per_frame", "seconds", "gpix_per_s",
            "max_u8_delta", "plan_build_ms", "fps",
            "pallas_mxu_gpix_per_s", "pallas_phase_gpix_per_s")

    t0 = time.perf_counter()
    zero_counts()
    table = cf.run_configs(dev=dev, card=name_power)
    torch.cuda.synchronize()
    counts = read_counts()
    rows = table["configs"]
    bad = cf.failures(rows, True)
    h, w, s = cf.CONFIGS["c4_4k_4x"]
    out4k = torch.empty((h * s, w * s, 4), dtype=torch.uint8, device=dev)
    floor_ms = time_ms(lambda: out4k.fill_(7))
    del out4k
    lines = {}
    for key, row in rows.items():
        lines[key] = brief(row, keys)
        lines[key]["bound_ms"], lines[key]["bound_by"] = config_bound(key,
                                                                      row)
        if "candidates" in row:
            lines[key]["candidates"] = {
                i: brief(cd, ("ms_per_frame", "gpix_per_s", "max_u8_delta",
                              "plan_build_ms", "ms_per_frame_with_fetch"))
                for i, cd in row["candidates"].items()}
    emit({"phase": "configs", "card": name_power, "rows": lines,
          "store_floor_4k_ms": floor_ms, "launches": counts,
          "seconds": time.perf_counter() - t0})
    if bad or others(counts) or not (counts["resize_mxu"]
                                     and counts["resize_phase"]):
        raise AssertionError(f"configs: {bad}, launches {counts}")

    latency_curve_phase(dev, name_power, zero_counts, read_counts)

    t0 = time.perf_counter()
    zero_counts()
    sections = ("rational", "downsample")
    out = methods.run(sections, dev=dev, card=name_power)
    torch.cuda.synchronize()
    counts = read_counts()
    bad = methods.failures(out, True)
    lines = {}
    for key, row in out.items():
        lines[key] = brief(row, ("impl", "ms_per_frame", "gpix_per_s",
                                 "max_u8_delta", "plan_build_ms",
                                 "in_mpix_per_s", "pallas_mxu_gpix_per_s",
                                 "phase_gpix_per_s", "matmul_gpix_per_s"))
    emit({"phase": "method_throughput", "card": name_power,
          "sections": list(sections), "rows": lines, "launches": counts,
          "seconds": time.perf_counter() - t0})
    if bad or any(v for k, v in counts.items() if k != "resize_mxu") \
            or not counts["resize_mxu"]:
        raise AssertionError(f"method_throughput: {bad}, launches {counts}")

    n, mx, share = crop_vs_plain(mxu, phase, dev)
    emit({"phase": "measurement_crops_vs_plain", "cases": n, "max": mx,
          "share": share})
    if mx > 1 or share >= 1e-2:
        raise AssertionError(f"crops vs plain: {mx} LSB, share {share}")
    torch.cuda.empty_cache()


def serving_policy_path(name_power, zero_counts, read_counts):
    """``stream(microbatch="auto")`` at the largest size of each curve
    that its threshold groups: 16 NxN RGBA frames through ``Upscaler``
    (4x; kernel C once a group, each frame byte-equal to its single
    launch) and through ``ModelUpscaler`` on the curve's checkpoint
    (kernel A once a group, B once a one-frame group; each frame ≤1 u8
    from its single launch), the seven kernels' counts at 0 just before
    each stream and read just after it; any other launch fails."""
    from bicubic_interpolation_model_tpu_torch.bench import configs as cf
    from bicubic_interpolation_model_tpu_torch.serving import (
        ModelUpscaler, Upscaler, group_size)
    t0 = time.perf_counter()
    rng = np.random.default_rng(16)
    n_frames = 16
    paths = {"classical": (Upscaler(scale=cf.LATENCY_SCALE),
                           cf.LATENCY_SIZES, False),
             "learned": (ModelUpscaler(str(ROOT / cf.LEARNED_MODEL)),
                         cf.LEARNED_SIZES, True)}
    lines, failed = {}, []
    for name, (up, sizes, learned) in paths.items():
        groups = {n: group_size("auto", n * n, up.MICROBATCH_THRESHOLD_PX,
                                up.MICROBATCH_TARGET_PX) for n in sizes}
        n = max(k for k, g in groups.items() if g > 1)
        frames = list(rng.integers(0, 256, (n_frames, n, n, 4),
                                   dtype=np.uint8))
        up(frames[0])                            # plans, cuDNN's choice
        torch.cuda.synchronize()
        zero_counts()
        got = list(up.stream(frames))
        torch.cuda.synchronize()
        counts = read_counts()
        want = cf.stream_launches(n_frames, groups[n], learned)
        worst = max(int(np.abs(o.astype(np.int16) - up(f)).max())
                    for f, o in zip(frames, got))
        lines[name] = {"size": f"{n}x{n}", "group": groups[n],
                       "threshold_px": up.MICROBATCH_THRESHOLD_PX,
                       "frames": len(got), "launches": counts,
                       "expected_launches": want,
                       "max_u8_vs_single": worst}
        if counts != want or len(got) != n_frames \
                or worst > (1 if learned else 0):
            failed.append(name)
        del got, frames
    emit({"phase": "serving_policy", "card": name_power, **lines,
          "seconds": time.perf_counter() - t0})
    if failed:
        raise AssertionError(f"serving_policy: {failed}: {lines}")
    torch.cuda.empty_cache()


def results_path(dev, name_power, zero_counts, read_counts):
    """``results``: every committed ``results_torch/*.json`` fresh or
    stale against this checkout's ``source_sha256``, and two committed
    rows of ``method_throughput.json`` re-timed through the same
    ``bench/methods`` code, with the seven kernels' counts at 0 before and
    read after: bicubic 1080p -> 4x through kernel C (``resize_row``, the
    ``pallas_mxu`` candidate of the ``bicubic`` row) and ``wp-1e-3-120``
    at 348x510 RGBA (``learned_row``: kernel A, writing HWC bytes). Each
    is printed beside its committed value with the ratio; an output more
    than 1 u8 from its oracle (the float64 oracle; the graph tail) or
    launches other than the row's expected ones fail, a timing
    disagreement does not."""
    from bicubic_interpolation_model_tpu_torch.bench import configs as cf
    from bicubic_interpolation_model_tpu_torch.bench import methods
    t0 = time.perf_counter()
    sha = cf.source_sha256()
    files = {name: {"source_sha256": got, "status": state}
             for name, (got, state) in cf.freshness(sha).items()}
    kept = json.loads((cf.CARD_RESULTS_DIR / "method_throughput.json")
                      .read_text())
    zero_counts()
    c_row = methods.resize_row(*methods.FULL.hd, 4, "bicubic", "pallas_mxu",
                               dev=dev)
    lr = methods.lr_frame(np.random.default_rng(0), methods.FULL, dev)
    a_row = methods.learned_row(ROOT / "model" / "wp-1e-3-120", lr, dev=dev)
    torch.cuda.synchronize()
    counts = read_counts()
    rows = {"bicubic_1080p_4x pallas_mxu": (
                c_row, kept["bicubic"]["candidates"]["pallas_mxu"]),
            "wp-1e-3-120": (a_row, kept["wp-1e-3-120"])}
    lines, bad = {}, []
    for key, (row, old) in rows.items():
        lines[key] = {"ms": row["ms_per_frame"],
                      "committed_ms": old["ms_per_frame"],
                      "ratio": row["ms_per_frame"] / old["ms_per_frame"],
                      "max_u8_delta": row["max_u8_delta"],
                      "launches": {k: v for k, v in row["launches"].items()
                                   if v},
                      "launches_as_expected": row["expected_launches"]
                      == row["launches"]}
        if row["max_u8_delta"] > 1 \
                or row["launches"] != row["expected_launches"]:
            bad.append(key)
    emit({"phase": "results", "card": name_power, "source_sha256": sha,
          "committed": kept["_provenance"]["card"], "files": files,
          "rows": lines, "launches": counts,
          "seconds": time.perf_counter() - t0})
    path = ("resize_mxu", "packed_tail_fused")
    if bad or any(v for k, v in counts.items() if k not in path) \
            or not all(counts[k] for k in path):
        raise AssertionError(f"results: {bad}, launches {counts}")
    torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    from bicubic_interpolation_model_tpu_torch.models.inference import (
        super_resolve)
    from bicubic_interpolation_model_tpu_torch.ops import (
        adaptive_fused as adf)
    from bicubic_interpolation_model_tpu_torch.ops import banded
    from bicubic_interpolation_model_tpu_torch.ops import interleave as ilv
    from bicubic_interpolation_model_tpu_torch.ops import mxu, phase
    from bicubic_interpolation_model_tpu_torch.ops import packed_tail as pt
    from bicubic_interpolation_model_tpu_torch.core import plan as planlib
    from bicubic_interpolation_model_tpu_torch.ops.adaptive import (
        adaptive_resize, luma_bt709, region_classes)
    from bicubic_interpolation_model_tpu_torch.ops.resize import (
        resize, round_u8)
    from bicubic_interpolation_model_tpu_torch.parallel import batch as bp
    from bicubic_interpolation_model_tpu_torch.parallel import spatial as sp
    from bicubic_interpolation_model_tpu_torch.parallel.mesh import Mesh
    from bicubic_interpolation_model_tpu_torch.runtime import build
    from bicubic_interpolation_model_tpu_torch.serving import (
        ModelUpscaler, Upscaler)

    # the launch counts of the seven kernels' wrappers
    from bicubic_interpolation_model_tpu_torch.bench.configs import WRAPPERS
    wrappers = WRAPPERS

    def zero_counts():
        for fn in wrappers.values():
            fn.launches = 0

    def read_counts():
        return {k: fn.launches for k, fn in wrappers.items()}

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
    ptxas = {src: build.ptxas_summary(log) for src, log in rec["ptxas"].items()}
    build.library()
    emit({"phase": "build", "seconds": round(rec["seconds"], 3),
          "sources": [s.name for s in build.sources()], "ptxas": ptxas,
          "sass_hmma": build.sass_hmma(build.BUILD_DIR / build.LIB_NAME)})

    # 3. kernel A vs its plain version (batches of 3 at the MMA edges)
    a_err = 0
    for i, (h, w, c) in enumerate(GEOMETRIES + MMA_EDGES):
        batch = 3 if (h, w, c) in MMA_EDGES else 1
        args = tail_case(h, w, c, dev, seed=1000 + i, batch=batch)
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
        res = {"phase": "kernel_a", "geometry": [h, w, c], "batch": batch,
               "f32_max": mx,
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

    # 4b. kernels C and D vs their plain versions (small geometries here;
    # the full 1080x1920 frame is held in the upscaler path below)
    c_err = check_kernel_c(mxu, dev, emit)
    d_err = check_kernel_d(phase, dev, emit)
    e_err = check_kernel_e(adf, ilv, dev, emit)
    f_err = check_kernel_f(banded, mxu, dev, emit)
    g_err = check_kernel_g(pt, dev, emit)

    # 5. main path: ModelUpscaler on the committed checkpoint
    up = ModelUpscaler(str(ROOT / "model" / "wp-1e-3-120"))
    rng = np.random.default_rng(20)
    frames = rng.integers(0, 256, (10,) + FRAME + (4,), dtype=np.uint8)
    frames[..., 3] = 255
    pt.packed_tail_fused.launches = 0
    pt.packed_tail.launches = 0
    ilv.interleave_planar_u32.launches = 0
    outs = [up(f) for f in frames[:4]]
    outs += list(up.stream(iter(frames[4:8])))
    outs_b = up.batch(frames[8:10])
    torch.cuda.synchronize()
    launches = {"packed_tail_fused": pt.packed_tail_fused.launches,
                "packed_tail": pt.packed_tail.launches,
                "interleave_planar_u32": ilv.interleave_planar_u32.launches}
    emit({"phase": "main_path", "requests": 8, "batch": 2,
          "launches": launches})
    if launches != {"packed_tail_fused": 9, "packed_tail": 0,
                    "interleave_planar_u32": 8}:
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

    # 5b. the classical path: Upscaler at 1080x1920 RGBA -> 4x (kernel C
    # by __call__, stream and batch), 2.5x, and the forced phase route
    # (kernel D)
    rng = np.random.default_rng(21)
    hd = u8_frames(rng, 10, *HD, 4)
    up4 = Upscaler(scale=4)
    up25 = Upscaler(scale=2.5)
    up_ph = Upscaler(scale=4, impl="pallas_phase")
    mxu.resize_mxu.launches = 0
    phase.resize_phase.launches = 0
    hd_outs = [up4(f) for f in hd[:4]]
    hd_outs += list(up4.stream(iter(hd[4:8])))
    hd_outs += list(up4.batch(hd[8:10]))
    out25 = up25(hd[0])
    out_ph = up_ph(hd[1])
    torch.cuda.synchronize()
    launches_cd = {"resize_mxu": mxu.resize_mxu.launches,
                   "resize_phase": phase.resize_phase.launches}
    emit({"phase": "upscaler_path", "frame": [*HD, 4], "requests": 8,
          "batch": 2, "scale_2_5": 1, "forced_phase": 1,
          "launches": launches_cd})
    if launches_cd != {"resize_mxu": 10, "resize_phase": 1}:
        raise AssertionError(f"the upscaler path did not run the kernels "
                             f"as expected: {launches_cd}")
    plans4 = next(iter(up4._weight_cache.values()))[:4]
    plans25 = next(iter(up25._weight_cache.values()))[:4]
    wrow, wcol, taps_d, left_d = next(iter(up_ph._weight_cache.values()))[:4]
    checks = [(o, hd[i], 4, lambda x: mxu.resize_mxu_reference(
        x, *plans4, dtype=torch.float64)) for i, o in enumerate(hd_outs)]
    checks.append((out25, hd[0], 2.5, lambda x: mxu.resize_mxu_reference(
        x, *plans25, dtype=torch.float64)))
    checks.append((out_ph, hd[1], 4, lambda x: phase.resize_phase_reference(
        x, wrow, wcol, 4, taps_d, left_d, dtype=torch.float64)))
    worst_g, worst_64 = (0, 0.0), (0, 0.0)
    for i, (o, frame, scale, oracle) in enumerate(checks):
        want_shape = (int(np.floor(HD[0] * scale + 0.5)),
                      int(np.floor(HD[1] * scale + 0.5)), 4)
        if (o.shape != want_shape or o.dtype != np.uint8
                or o[::8, ::8].std() == 0):
            raise AssertionError(f"bad output {i}: {o.shape} {o.dtype}")
        got = torch.from_numpy(np.ascontiguousarray(o)).to(dev)
        g = diff_u8(got, resize(frame, scale, impl="gather"))
        f64 = diff_u8(got, oracle(torch.from_numpy(frame).to(dev)[None])[0])
        worst_g, worst_64 = max(worst_g, g), max(worst_64, f64)
        if g[0] > 1 or f64[0] > 1 or g[1] >= 1e-3 or f64[1] >= 1e-3:
            raise AssertionError(f"upscaler output {i} (x{scale}): {g} vs "
                                 f"gather, {f64} vs the float64 version")
    c_vs_d = diff_u8(torch.from_numpy(out_ph).to(dev),
                     torch.from_numpy(hd_outs[1]).to(dev))
    emit({"phase": "upscaler_path_check", "outputs": len(checks),
          "vs_gather_max": worst_g[0], "vs_gather_share": worst_g[1],
          "vs_float64_max": worst_64[0], "vs_float64_share": worst_64[1],
          "kernel_d_vs_kernel_c_max": c_vs_d[0],
          "kernel_d_vs_kernel_c_share": c_vs_d[1]})
    # the full frame, kernel vs its f32 plain version
    hd_dev = torch.from_numpy(hd[:1]).to(dev)
    full_c = diff_u8(mxu.resize_mxu(hd_dev, 4, "bicubic"),
                     mxu.resize_mxu_reference(hd_dev, *plans4))
    full_d = diff_u8(phase.resize_phase(hd_dev, 4, "bicubic"),
                     phase.resize_phase_reference(hd_dev, wrow, wcol, 4,
                                                  taps_d, left_d))
    emit({"phase": "full_frame_vs_plain", "kernel_c_max": full_c[0],
          "kernel_c_share": full_c[1], "kernel_d_max": full_d[0],
          "kernel_d_share": full_d[1]})
    if max(full_c[0], full_d[0]) > 1 or max(full_c[1], full_d[1]) >= 1e-3:
        raise AssertionError("a kernel disagrees with its plain version at "
                             "the full frame")
    c_err, d_err = max(c_err, full_c[0]), max(d_err, full_d[0])
    del hd_outs, checks, out25, out_ph

    # 5c. the adaptive path: Upscaler(method="adaptive") at 1080x1920 RGBA
    # -> 4x (kernel E by __call__ with and without the fetch, batch and
    # stream) and resize(impl="pallas") on the same frame (kernel F); host
    # copies of the 132.7 MB results are dropped as they are checked
    rng = np.random.default_rng(23)
    ad = all_class_frames(rng, 8, *HD, 4)
    up_ad = Upscaler(scale=4, method="adaptive")
    ad_shape = (HD[0] * 4, HD[1] * 4, 4)
    ad_dev = torch.from_numpy(ad).to(dev)
    wts_e = adf._weights(*HD, 4, -0.5, dev, None)
    worst_e = (0, 0.0)

    def check_adaptive(out, i):
        nonlocal worst_e
        if (out.shape != ad_shape or out.dtype != np.uint8
                or out[::8, ::8].std() == 0):
            raise AssertionError(f"bad adaptive output {i}: {out.shape} "
                                 f"{out.dtype}")
        d = diff_u8(torch.from_numpy(np.ascontiguousarray(out)).to(dev),
                    adf.adaptive_resize_reference(ad_dev[i:i + 1], *wts_e,
                                                  4)[0])
        worst_e = max(worst_e, d)
        if d[0] > 1 or d[1] >= 1e-3:
            raise AssertionError(f"adaptive output {i}: {d} vs the plain "
                                 f"version")

    adf.adaptive_resize_fused.launches = 0
    banded.resize_banded.launches = 0
    served = [(up_ad(ad[0]), 0), (up_ad(ad[1]), 1)]
    words = up_ad(ad[2], fetch=False)
    out_f = resize(ad[0], 4, impl="pallas")
    batch_ad = up_ad.batch(ad[3:5], fetch=False)
    served += zip(up_ad.stream(iter(ad[5:7])), (5, 6))
    torch.cuda.synchronize()
    launches_ef = {"adaptive_resize_fused": adf.adaptive_resize_fused.launches,
                   "resize_banded": banded.resize_banded.launches}
    emit({"phase": "adaptive_path", "frame": [*HD, 4], "scale": 4,
          "requests_fetched": 2, "requests_device": 1, "batch": 2,
          "stream": 2, "resize_impl_pallas": 1, "launches": launches_ef})
    # 2 fetched frames + 1 device frame + 1 batch + 2 streamed frames
    if launches_ef != {"adaptive_resize_fused": 6, "resize_banded": 1}:
        raise AssertionError(f"the adaptive path did not run the kernels "
                             f"as expected: {launches_ef}")
    if words.dtype != torch.uint32 or words.shape != ad_shape[:2]:
        raise AssertionError(f"fetch=False gave {words.dtype} "
                             f"{tuple(words.shape)}, not RGBA32 words")
    for out, i in served:
        check_adaptive(out, i)
    del served
    check_adaptive(words.view(torch.uint8).reshape(ad_shape).cpu().numpy(), 2)
    for k in range(2):
        check_adaptive(batch_ad[k].cpu().numpy(), 3 + k)
    graph = diff_u8(words.view(torch.uint8).reshape(ad_shape),
                    adaptive_resize(ad[2], 4, impl="jnp"))
    cls_full = torch.empty((1, *HD), dtype=torch.uint8, device=dev)
    adf.adaptive_resize_fused(ad_dev[2:3], 4, classes_out=cls_full)
    cls_diff = float((cls_full != region_classes(luma_bt709(
        ad_dev[2:3].float()))).double().mean())
    # against float64 outside the cells whose class flips between f32 and
    # float64 (counted); everywhere else the <=1 LSB contract is held
    f64, f64_flipped_max, f64_flip_share = e_vs_float64(
        adf, words.view(torch.uint8).reshape(ad_shape), ad_dev[2:3],
        cls_full, wts_e, 4)
    class_share = [float((cls_full == k).double().mean()) for k in range(3)]
    del words, batch_ad
    b_row, b_colt, left_f = banded._bands("bicubic", *HD, 4, -0.5, 3, dev,
                                          None)[:3]
    f_plain = diff_u8(out_f, banded.resize_banded_reference(
        ad_dev[:1], b_row, b_colt, 4, left_f)[0])
    f_f64 = diff_u8(out_f, banded.resize_banded_reference(
        ad_dev[:1], b_row, b_colt, 4, left_f, dtype=torch.float64)[0])
    f_vs_c = diff_u8(out_f, mxu.resize_mxu(ad_dev[0], 4, "bicubic"))
    f_gather = diff_u8(out_f, resize(ad[0], 4, impl="gather"))
    emit({"phase": "adaptive_path_check", "outputs": 7,
          "kernel_e_vs_plain_max": worst_e[0],
          "kernel_e_vs_plain_share": worst_e[1],
          "kernel_e_vs_graph_max": graph[0],
          "kernel_e_vs_graph_share": graph[1],
          "kernel_e_vs_float64_max": f64[0],
          "kernel_e_vs_float64_share": f64[1],
          "class_f32_vs_float64_flip_share": f64_flip_share,
          "kernel_e_vs_float64_max_in_flipped_cells": f64_flipped_max,
          "kernel_e_class_diff_share": cls_diff,
          "share_texture_flat_edge": class_share,
          "kernel_f_vs_gather_max": f_gather[0],
          "kernel_f_vs_gather_share": f_gather[1],
          "kernel_f_vs_kernel_c_max": f_vs_c[0],
          "kernel_f_vs_kernel_c_share": f_vs_c[1]})
    emit({"phase": "full_frame_vs_plain", "path": "adaptive",
          "kernel_e_max": worst_e[0], "kernel_e_share": worst_e[1],
          "kernel_f_max": f_plain[0], "kernel_f_share": f_plain[1],
          "kernel_f_float64_max": f_f64[0],
          "kernel_f_float64_share": f_f64[1]})
    if (max(graph[0], f64[0], f_plain[0], f_f64[0], f_vs_c[0],
            f_gather[0]) > 1
            or max(graph[1], f64[1], f_plain[1], f_f64[1], f_vs_c[1],
                   f_gather[1]) >= 1e-3 or cls_diff != 0.0
            # the cells left out of the float64 comparison stay few
            or f64_flip_share >= 1e-4):
        raise AssertionError("the adaptive path disagrees with its plain "
                             "versions at the full frame")
    e_err, f_err = max(e_err, worst_e[0]), max(f_err, f_plain[0])
    del out_f
    torch.cuda.empty_cache()

    # 5c'. a gray frame on the adaptive path: Upscaler(method="adaptive") at
    # 1080x1920x1 -> 4x, kernel E once; the other 31 gray frames and 16
    # two-channel frames are the rotated inputs of its times below
    rng = np.random.default_rng(24)
    gray_dev = torch.from_numpy(all_class_frames(rng, 32, *HD, 1)).to(dev)
    two_dev = torch.from_numpy(all_class_frames(rng, 16, *HD, 2)).to(dev)
    gray0 = gray_dev[0].cpu().numpy()
    zero_counts()
    gray_out = up_ad(gray0)
    torch.cuda.synchronize()
    launches_gray = read_counts()
    emit({"phase": "adaptive_gray_path", "frame": [*HD, 1], "scale": 4,
          "requests_fetched": 1, "launches": launches_gray})
    if launches_gray != {**{k: 0 for k in wrappers},
                         "adaptive_resize_fused": 1}:
        raise AssertionError(f"the gray frame did not run kernel E once: "
                             f"{launches_gray}")
    if (gray_out.shape != (HD[0] * 4, HD[1] * 4, 1)
            or gray_out.dtype != np.uint8 or gray_out[::8, ::8].std() == 0):
        raise AssertionError(f"bad gray output {gray_out.shape} "
                             f"{gray_out.dtype}")
    gray_got = torch.from_numpy(gray_out).to(dev)
    del gray_out
    gray_plain = diff_u8(gray_got, adf.adaptive_resize_reference(
        gray_dev[:1], *wts_e, 4)[0])
    cls_gray = torch.empty((1, *HD), dtype=torch.uint8, device=dev)
    adf.adaptive_resize_fused(gray_dev[:1], 4, classes_out=cls_gray)
    gray_cls_diff = float((cls_gray != region_classes(luma_bt709(
        gray_dev[:1].float()))).double().mean())
    gray_f64, gray_flipped_max, gray_flip_share = e_vs_float64(
        adf, gray_got, gray_dev[:1], cls_gray, wts_e, 4)
    gray_share = [float((cls_gray == k).double().mean()) for k in range(3)]
    cls_two = region_classes(luma_bt709(two_dev[:1].float()))
    two_share = [float((cls_two == k).double().mean()) for k in range(3)]
    del gray_got, cls_two
    emit({"phase": "adaptive_gray_path_check",
          "kernel_e_vs_plain_max": gray_plain[0],
          "kernel_e_vs_plain_share": gray_plain[1],
          "kernel_e_vs_float64_max": gray_f64[0],
          "kernel_e_vs_float64_share": gray_f64[1],
          "class_f32_vs_float64_flip_share": gray_flip_share,
          "kernel_e_vs_float64_max_in_flipped_cells": gray_flipped_max,
          "kernel_e_class_diff_share": gray_cls_diff,
          "share_texture_flat_edge": gray_share})
    if (max(gray_plain[0], gray_f64[0]) > 1
            or max(gray_plain[1], gray_f64[1]) >= 1e-3
            or gray_cls_diff != 0.0 or gray_flip_share >= 1e-4):
        raise AssertionError("the gray frame disagrees with kernel E's "
                             "plain versions")
    e_err = max(e_err, gray_plain[0])
    torch.cuda.empty_cache()

    # 5d. the band-sharded learned path: learned_resize_spatial_sharded on
    # the committed checkpoints at the full 348x510 RGBA frame, meshes of 2
    # and 4 bands on the one card (kernel G once per band)
    meshes = {n: Mesh([dev] * n, ("spatial",)) for n in (2, 4)}
    pt.packed_tail.launches = 0
    pt.packed_tail_fused.launches = 0
    sharded = {n: sp.learned_resize_spatial_sharded(
        up.model, up.params, frames[0], 4, mesh=meshes[n]) for n in (2, 4)}
    sharded_a = sp.learned_resize_spatial_sharded(
        up_a.model, up_a.params, frames[0], 4, mesh=meshes[4])
    torch.cuda.synchronize()
    launches_g = {"packed_tail": pt.packed_tail.launches,
                  "packed_tail_fused": pt.packed_tail_fused.launches}
    emit({"phase": "sharded_learned", "frame": [*FRAME, 4],
          "bands": [2, 4], "adaptive_checkpoint_bands": 4,
          "launches": launches_g})
    if launches_g != {"packed_tail": 2 + 4 + 4, "packed_tail_fused": 0}:
        raise AssertionError(f"the sharded learned path did not launch "
                             f"kernel G once per band: {launches_g}")
    res = {"phase": "sharded_learned_check"}
    for key, n, got, model, single in (
            ("wp_2_bands", 2, sharded[2], up, outs[0]),
            ("wp_4_bands", 4, sharded[4], up, outs[0]),
            ("wp_adaptive_4_bands", 4, sharded_a, up_a, oa)):
        graph = sp.learned_resize_spatial_sharded(
            model.model, model.params, frames[0], 4, mesh=meshes[n],
            tail="graph")
        vs_graph = diff_u8(got, graph)
        vs_single = diff_u8(got, torch.as_tensor(single).to(dev))
        res[key] = {"vs_sharded_graph_max": vs_graph[0],
                    "vs_sharded_graph_share": vs_graph[1],
                    "vs_model_upscaler_max": vs_single[0],
                    "vs_model_upscaler_share": vs_single[1],
                    "std": round(float(got.float().std()), 3)}
        if (got.shape != hw or vs_graph[0] > 1 or vs_graph[1] >= 1e-3
                or vs_single[0] > 2 or float(got.float().std()) == 0):
            raise AssertionError(f"sharded learned {key}: {res[key]}")
        g_err = max(g_err, vs_graph[0])
    emit(res)
    del sharded, sharded_a

    # 5e. the band-sharded classical path: 1080x1920 RGBA -> 4x bicubic
    # over 4 bands, kernel C per band, byte-equal to the single-frame kernel
    mxu.resize_mxu.launches = 0
    sc = sp.resize_spatial_sharded(hd[0], 4, mesh=meshes[4], impl="mxu")
    torch.cuda.synchronize()
    launches_sc = mxu.resize_mxu.launches
    sc_equal = torch.equal(sc, mxu.resize_mxu(torch.from_numpy(hd[0]).to(dev),
                                              4, "bicubic"))
    # the einsum bands on a 480-column crop (dense column matrices: the
    # full width would take seconds), against the kernel's bands
    crop = np.ascontiguousarray(hd[0][:, :480])
    ein = diff_u8(sp.resize_spatial_sharded(crop, 4, mesh=meshes[4],
                                            impl="einsum"),
                  sp.resize_spatial_sharded(crop, 4, mesh=meshes[4],
                                            impl="mxu"))
    emit({"phase": "sharded_classical", "frame": [*HD, 4], "bands": 4,
          "launches": {"resize_mxu": launches_sc},
          "equal_to_single_frame_kernel": sc_equal,
          "einsum_frame": [HD[0], 480, 4], "einsum_vs_mxu_max": ein[0],
          "einsum_vs_mxu_share": ein[1]})
    if launches_sc != 4 or not sc_equal or ein[0] > 1 or ein[1] >= 1e-3:
        raise AssertionError("the sharded classical path disagrees with "
                             "the single-frame kernel")
    del sc

    # 5f. the band-sharded adaptive path: an all-class 1080x1920 RGBA frame
    # -> 4x over 4 bands, kernel E per band, byte-equal to the single frame
    adf.adaptive_resize_fused.launches = 0
    sa = sp.adaptive_resize_spatial_sharded(ad[0], 4, mesh=meshes[4])
    torch.cuda.synchronize()
    launches_sa = adf.adaptive_resize_fused.launches
    sa_equal = torch.equal(sa, adf.adaptive_resize_fused(ad_dev[0], 4))
    sa_planar = torch.equal(
        sp.adaptive_resize_spatial_sharded(ad[0], 4, mesh=meshes[4],
                                           layout="planar"),
        adf.adaptive_resize_fused(ad_dev[0], 4, layout="planar"))
    emit({"phase": "sharded_adaptive", "frame": [*HD, 4], "bands": 4,
          "launches": {"adaptive_resize_fused": launches_sa},
          "hwc_equal_to_single_frame_kernel": sa_equal,
          "planar_equal_to_single_frame_kernel": sa_planar})
    if launches_sa != 4 or not (sa_equal and sa_planar):
        raise AssertionError("the sharded adaptive path disagrees with the "
                             "single-frame kernel")
    del sa

    # 5g. the batch-sharded path: 8 frames of 1080x1920 RGBA -> 4x over a
    # 4-shard data axis, kernel D per shard
    phase.resize_phase.launches = 0
    bo = bp.resize_batch_sharded(hd[:8], 4, mesh=Mesh([dev] * 4, ("data",)))
    torch.cuda.synchronize()
    launches_bo = phase.resize_phase.launches
    bo_equal = all(torch.equal(bo[i], phase.resize_phase(
        torch.from_numpy(hd[i]).to(dev), 4)) for i in range(8))
    emit({"phase": "batch_sharded", "frames": 8, "frame": [*HD, 4],
          "shards": 4, "launches": {"resize_phase": launches_bo},
          "equal_to_single_frame_kernel": bo_equal})
    if launches_bo != 4 or not bo_equal:
        raise AssertionError("the sharded batch path disagrees with kernel "
                             "D")
    del bo
    torch.cuda.empty_cache()

    # 6. times at the main path's shapes
    # inputs rotate over 4 (A) or 8 (B) copies, 91 MB each way, so every
    # call reads from HBM and not from the 50 MB L2
    h, w = FRAME
    args = tail_case(h, w, 4, dev, seed=7)
    a_in = [(args[0].clone(), args[1].clone()) for _ in range(4)]
    run_a = rotating(lambda y, lr: pt.packed_tail_fused(
        y, lr, *args[2:], layout="planar"), a_in)
    run_a_bf16 = rotating(lambda y, lr: pt.packed_tail_fused(
        y, lr, *args[2:], layout="planar"),
        [(y.to(torch.bfloat16), lr) for y, lr in a_in])
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
    # profiler
    a_call = time_ms(run_a, iters=10)
    a_plain_call = time_ms(run_a_plain, runs=5)
    b_call = time_ms(run_b, iters=50)
    b_plain_call = time_ms(run_b_plain, iters=50)
    b_lib_call = time_ms(run_b_lib, iters=50)
    a_ms = device_ms(run_a, kernel="packed_tail_fused_kernel")
    # the wrapper rounds the parameters to bf16 per call (small kernels of
    # their own, left out)
    a_bf16_ms = device_ms(run_a_bf16, kernel="packed_tail_fused_kernel")
    a_plain = device_ms(run_a_plain, n=5)
    b_ms = device_ms(run_b, kernel="interleave_kernel")
    b_plain = device_ms(run_b_plain)
    b_lib = device_ms(run_b_lib)
    lr_dev = torch.as_tensor(frames[0]).to(dev)
    call_dev = time_ms(lambda: up(lr_dev, fetch=False), iters=10)
    call_host = time_ms(lambda: up(frames[0]))
    a_bound, a_by, a_bytes, a_flops = tail_bound(h, w, 4, 4)
    a_bf16_bound, a_bf16_by, _, _ = tail_bound(h, w, 4, 2)
    b_bytes = 2 * planar.numel() * 4
    b_bound = b_bytes / HBM_BYTES_PER_S * 1e3
    emit({"phase": "times", "card": name_power, "frame": [h, w, 4],
          "packed_tail_fused_ms": a_ms,
          "packed_tail_fused_bf16_ms": a_bf16_ms,
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
          "packed_tail_bound_ms": a_bound, "packed_tail_bound_by": a_by,
          "packed_tail_bf16_bound_ms": a_bf16_bound,
          "packed_tail_bf16_bound_by": a_bf16_by,
          "interleave_bytes": b_bytes, "interleave_bound_ms": b_bound})

    prof = profile_served_frames(up, frames[0], 5, {
        "packed_tail_fused_ms_per_frame": "packed_tail_fused_kernel",
        "interleave_planar_u32_ms_per_frame": "interleave_kernel"})
    emit({"phase": "profile", "card": name_power, **prof,
          "packed_tail_fused_share_of_device_busy":
              prof["packed_tail_fused_ms_per_frame"]
              / prof["device_busy_ms_per_frame"]})

    # 6b. times of the classical path at 1080x1920 RGBA -> 4x: inputs
    # rotate over 8 copies (66 MB), and each call writes 132.7 MB, so every
    # launch reads from HBM
    c_in = [(torch.from_numpy(hd[i:i + 1]).to(dev),) for i in range(8)]
    wc_c, wc_d = {}, {}
    run_c = rotating(lambda x: mxu.resize_mxu(
        x, 4, "bicubic", weight_cache=wc_c), c_in)
    run_d = rotating(lambda x: phase.resize_phase(
        x, 4, "bicubic", weight_cache=wc_d), c_in)
    run_d_planar = rotating(lambda x: phase.resize_phase(
        x, 4, "bicubic", weight_cache=wc_d, layout="planar"), c_in)
    run_c25 = rotating(lambda x: mxu.resize_mxu(
        x, 2.5, "bicubic", weight_cache=wc_c), c_in)
    run_c_plain = rotating(lambda x: mxu.resize_mxu_reference(
        x, *plans4), c_in)
    run_d_plain = rotating(lambda x: phase.resize_phase_reference(
        x, wrow, wcol, 4, taps_d, left_d), c_in)
    # library yardstick: the port's impl="matmul" arithmetic with its two
    # dense sampling matrices already on the card (two torch.matmul, round,
    # permute to HWC)
    m_row, m_col_t = (torch.from_numpy(planlib.plan_to_matrix(
        planlib.plan_axis("bicubic", n, 4.0))).to(dev) for n in HD)
    m_col_t = m_col_t.T.contiguous()

    def matmul_resize(x):
        chw = x[0].permute(2, 0, 1).to(torch.float32)
        return round_u8(torch.matmul(torch.matmul(m_row, chw),
                                     m_col_t).permute(1, 2, 0)).contiguous()
    # the store floor: one fill of a 132.7 MB output (bytes out only)
    fill_out = torch.empty((1, HD[0] * 4, HD[1] * 4, 4), dtype=torch.uint8,
                           device=dev)
    store_floor = device_ms(lambda: fill_out.fill_(7))
    del fill_out
    lib_err = diff_u8(matmul_resize(c_in[0][0]),
                      mxu.resize_mxu(c_in[0][0], 4, "bicubic")[0])
    if lib_err[0] > 1:
        raise AssertionError(f"the matmul yardstick computes another "
                             f"function: {lib_err}")
    run_lib = rotating(matmul_resize, c_in)
    c_call = time_ms(run_c, iters=10)
    d_call = time_ms(run_d, iters=10)
    c_ms = device_ms(run_c, kernel="resize_plan_kernel")
    d_ms = device_ms(run_d, kernel="resize_phase_kernel")
    d_planar_ms = device_ms(run_d_planar, kernel="resize_phase_kernel")
    c25_ms = device_ms(run_c25, kernel="resize_plan_kernel")
    c_plain = device_ms(run_c_plain, n=3, warmup=1)
    d_plain = device_ms(run_d_plain, n=3, warmup=1)
    lib_ms = device_ms(run_lib, n=5, warmup=2)
    torch.cuda.empty_cache()
    ho, wo = HD[0] * 4, HD[1] * 4
    cd_bound, cd_by, cd_bytes, cd_flops = resize_bound(
        1, *HD, 4, ho, wo, 4, 1)
    frame_dev = c_in[0][0][0]
    up_dev = time_ms(lambda: up4(frame_dev, fetch=False), iters=10)
    up_host = time_ms(lambda: up4(hd[0]), runs=10)
    ph_dev = time_ms(lambda: up_ph(frame_dev, fetch=False), iters=10)
    emit({"phase": "times_classical", "card": name_power,
          "frame": [*HD, 4], "scale": 4, "method": "bicubic",
          "resize_mxu_ms": c_ms, "resize_phase_ms": d_ms,
          "resize_phase_planar_ms": d_planar_ms,
          "resize_mxu_scale_2_5_ms": c25_ms,
          "resize_mxu_plain_ms_no_yardstick": c_plain,
          "resize_phase_plain_ms_no_yardstick": d_plain,
          "resize_matmul_library_ms": lib_ms,
          "store_floor_fill_132_7_mb_ms": store_floor,
          "per_call_ms_with_host_launch": {"resize_mxu": c_call,
                                           "resize_phase": d_call},
          "bytes": cd_bytes, "flops": cd_flops, "bound_ms": cd_bound,
          "bound_by": cd_by,
          "upscaler_call_device_ms": up_dev,
          "upscaler_call_fetch_ms": up_host,
          "upscaler_forced_phase_call_device_ms": ph_dev,
          "output_gpix_per_s_device": ho * wo / up_dev / 1e6,
          "output_gpix_per_s_with_fetch": ho * wo / up_host / 1e6})

    emit({"phase": "profile_classical", "card": name_power,
          **profile_served_frames(up4, hd[0], 5, {
              "resize_mxu_ms_per_frame": "resize_plan_kernel",
              "memcpy_dtoh_ms_per_frame": "Memcpy DtoH",
              "memcpy_htod_ms_per_frame": "Memcpy HtoD"})})

    # 6c. times of the adaptive path at 1080x1920 RGBA -> 4x: kernel E on
    # the 8 all-class frames in turn (66 MB of input, 132.7 MB written per
    # call), kernel F on the classical path's 8 frames, so that its library
    # yardstick is the one timed above
    e_in = [(ad_dev[i:i + 1],) for i in range(8)]
    wc_e, wc_f = {}, {}
    run_e = rotating(lambda x: adf.adaptive_resize_fused(
        x, 4, weight_cache=wc_e), e_in)
    run_e_planar = rotating(lambda x: adf.adaptive_resize_fused(
        x, 4, weight_cache=wc_e, layout="planar"), e_in)
    run_e_opaque = rotating(lambda x: adf.adaptive_resize_fused(
        x, 4, weight_cache=wc_e, opaque_alpha=True), e_in)
    # gray and two-channel frames, 66 MB of input each way round
    run_e_gray = rotating(lambda x: adf.adaptive_resize_fused(
        x, 4, weight_cache=wc_e), [(gray_dev[i:i + 1],) for i in range(32)])
    run_e_two = rotating(lambda x: adf.adaptive_resize_fused(
        x, 4, weight_cache=wc_e), [(two_dev[i:i + 1],) for i in range(16)])
    run_e_rgb = rotating(lambda x: adf.adaptive_resize_fused(
        x, 4, weight_cache=wc_e),
        [(x[..., :3].contiguous(),) for (x,) in e_in])
    run_e_plain = rotating(lambda x: adf.adaptive_resize_reference(
        x, *wts_e, 4), e_in)
    run_e_plain_gray = rotating(lambda x: adf.adaptive_resize_reference(
        x, *wts_e, 4), [(gray_dev[i:i + 1],) for i in range(2)])
    run_e_plain_two = rotating(lambda x: adf.adaptive_resize_reference(
        x, *wts_e, 4), [(two_dev[i:i + 1],) for i in range(2)])
    run_e_graph = rotating(lambda x: adaptive_resize(x[0], 4, impl="jnp"),
                           e_in)
    run_f = rotating(lambda x: banded.resize_banded(
        x, 4, "bicubic", weight_cache=wc_f), c_in)
    run_f_plain = rotating(lambda x: banded.resize_banded_reference(
        x, b_row, b_colt, 4, left_f), c_in)
    e_call = time_ms(run_e, iters=10)
    f_call = time_ms(run_f, iters=10)
    e_ms = device_ms(run_e, kernel="adaptive_kernel")
    e_planar_ms = device_ms(run_e_planar, kernel="adaptive_kernel")
    e_opaque_ms = device_ms(run_e_opaque, kernel="adaptive_kernel")
    e_gray_ms = device_ms(run_e_gray, kernel="adaptive_kernel")
    e_two_ms = device_ms(run_e_two, kernel="adaptive_kernel")
    e_rgb_ms = device_ms(run_e_rgb, kernel="adaptive_kernel")
    f_ms = device_ms(run_f, kernel="resize_banded_kernel")
    e_plain = device_ms(run_e_plain, n=2, warmup=1)
    e_plain_gray = device_ms(run_e_plain_gray, n=2, warmup=1)
    e_plain_two = device_ms(run_e_plain_two, n=2, warmup=1)
    e_graph = device_ms(run_e_graph, n=2, warmup=1)
    f_plain_ms = device_ms(run_f_plain, n=3, warmup=1)
    torch.cuda.empty_cache()
    e_bound, e_by, e_bytes, e_flops = adaptive_bound(1, *HD, 4, 4,
                                                     class_share[0])
    e_gray_bound = adaptive_bound(1, *HD, 1, 4, gray_share[0])
    e_two_bound = adaptive_bound(1, *HD, 2, 4, two_share[0])
    # the RGB channels of the RGBA frames: the same luma, so their classes
    e_rgb_bound = adaptive_bound(1, *HD, 3, 4, class_share[0])
    del gray_dev, two_dev
    # kernel F's tensor-core products as launched on this frame, beside its
    # bytes bound (its function's bound is resize_bound's)
    f_ops = next(iter(wc_f.values()))
    f_products = banded_products(1, 4, f_ops[3], f_ops[4], f_ops[1].shape[1],
                                 f_ops[0].shape[1])
    ad_frame_dev = ad_dev[0]
    ad_dev_ms = time_ms(lambda: up_ad(ad_frame_dev, fetch=False), iters=10)
    ad_host_ms = time_ms(lambda: up_ad(ad[0]), runs=5, warmup=2)
    emit({"phase": "times_adaptive", "card": name_power,
          "frame": [*HD, 4], "scale": 4,
          "adaptive_resize_fused_ms": e_ms,
          "adaptive_resize_fused_planar_ms": e_planar_ms,
          "adaptive_resize_fused_opaque_alpha_ms": e_opaque_ms,
          "gray": {"frame": [*HD, 1], "adaptive_resize_fused_ms": e_gray_ms,
                   "plain_ms_no_yardstick": e_plain_gray,
                   "bound_ms": e_gray_bound[0], "bound_by": e_gray_bound[1],
                   "bytes": e_gray_bound[2], "flops": e_gray_bound[3],
                   "share_texture_flat_edge": gray_share},
          "two_channel": {"frame": [*HD, 2],
                          "adaptive_resize_fused_ms": e_two_ms,
                          "plain_ms_no_yardstick": e_plain_two,
                          "bound_ms": e_two_bound[0],
                          "bound_by": e_two_bound[1],
                          "bytes": e_two_bound[2], "flops": e_two_bound[3],
                          "share_texture_flat_edge": two_share},
          "rgb": {"frame": [*HD, 3], "adaptive_resize_fused_ms": e_rgb_ms,
                  "bound_ms": e_rgb_bound[0], "bound_by": e_rgb_bound[1],
                  "bytes": e_rgb_bound[2], "flops": e_rgb_bound[3],
                  "share_texture_flat_edge": class_share},
          "adaptive_resize_fused_plain_ms_no_yardstick": e_plain,
          "adaptive_plain_graph_ms_no_yardstick": e_graph,
          "resize_banded_ms": f_ms,
          "resize_banded_plain_ms_no_yardstick": f_plain_ms,
          "resize_matmul_library_ms": lib_ms,
          "per_call_ms_with_host_launch": {"adaptive_resize_fused": e_call,
                                           "resize_banded": f_call},
          "adaptive_bytes": e_bytes, "adaptive_flops": e_flops,
          "adaptive_bound_ms": e_bound, "adaptive_bound_by": e_by,
          "share_texture_flat_edge": class_share,
          "resize_banded_bound_ms": cd_bound,
          "resize_banded_bound_by": cd_by,
          "resize_banded_products_flops": f_products[0],
          "resize_banded_products_3xtf32_ms": f_products[1],
          "upscaler_adaptive_call_device_ms": ad_dev_ms,
          "upscaler_adaptive_call_fetch_ms": ad_host_ms,
          "output_gpix_per_s_device": ho * wo / ad_dev_ms / 1e6,
          "output_gpix_per_s_with_fetch": ho * wo / ad_host_ms / 1e6})

    emit({"phase": "profile_adaptive", "card": name_power,
          **profile_served_frames(up_ad, ad[0], 3, {
              "adaptive_resize_fused_ms_per_frame": "adaptive_kernel",
              "memcpy_dtoh_ms_per_frame": "Memcpy DtoH",
              "memcpy_htod_ms_per_frame": "Memcpy HtoD"})})

    # 6c'. stream() against N x __call__ on 8 fetched 1080x1920 RGBA -> 4x
    # frames, bicubic and adaptive: host clock around all 8 host results,
    # in turns call / stream / stream / call; then one device result's
    # device->host copy in three forms,
    # 4 results kept per round: pageable, the serving form
    # (serving._start_fetch: pinned memory of each result's own, recycled by
    # PyTorch's host cache once a round's results are dropped) and one
    # pinned buffer reused, each result copied out into an owned array
    from bicubic_interpolation_model_tpu_torch.serving import _start_fetch
    overlap = {"phase": "stream_overlap", "card": name_power, "frames": 8,
               "frame": [*HD, 4], "scale": 4}
    for label, server, frames8 in (("bicubic", up4, list(hd[:8])),
                                   ("adaptive", up_ad, list(ad[:8]))):
        runs: dict = {"call": [], "stream": []}
        same, last = True, None
        for mode in ("call", "stream", "stream", "call"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = ([server(f) for f in frames8] if mode == "call"
                   else list(server.stream(iter(frames8))))
            runs[mode].append((time.perf_counter() - t0) * 1e3 / 8)
            # each run's frames against the run before; one run's frames
            # are dropped before the next but one, as a consumer that
            # drops its frames lets their pinned blocks serve later ones
            same = same and len(got) == 8 and (last is None or all(
                np.array_equal(a, b) for a, b in zip(got, last)))
            last = got
            del got
        del last
        overlap[label] = {"call_ms_per_frame": runs["call"],
                          "stream_ms_per_frame": runs["stream"],
                          "stream_bytes_equal_call": same}
        if not same:
            raise AssertionError(f"stream() and __call__ differ ({label})")
    dev_out = up4(frame_dev, fetch=False)
    ring = torch.empty(dev_out.shape, dtype=dev_out.dtype, pin_memory=True)
    fetch_forms: dict = {}
    for _ in range(2):
        for form in ("pageable", "pinned_own_storage",
                     "pinned_buffer_copied_out"):
            kept = []
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(4):
                if form == "pageable":
                    kept.append(dev_out.cpu().numpy())
                elif form == "pinned_own_storage":
                    kept.append(_start_fetch(dev_out)())
                else:
                    ring.copy_(dev_out, non_blocking=True)
                    torch.cuda.current_stream().synchronize()
                    kept.append(ring.clone().numpy())
            fetch_forms.setdefault(form, []).append(
                (time.perf_counter() - t0) * 1e3 / 4)
            del kept
    overlap["fetch_one_result_ms"] = fetch_forms
    del dev_out, ring
    emit(overlap)

    # 6d. times of kernel G at 348x510 (halo="zero") and on one band of 4
    # (halo="rows"), inputs rotated over two copies (two maps are 727 MB,
    # two band maps 186 MB); the sharded learned frame beside ModelUpscaler
    h, w = FRAME
    hb = h // 4
    g_in = [map_case(h, w, 4, "zero", dev, 70 + k) for k in range(2)]
    gb_in = [map_case(hb, w, 4, "rows", dev, 80 + k) for k in range(2)]
    kout_g, bout_g = g_in[0][2], g_in[0][3]
    run_g = rotating(lambda m, lr: pt.packed_tail(
        m, lr, kout_g, bout_g, layout="planar"), [a[:2] for a in g_in])
    run_gb = rotating(lambda m, lr: pt.packed_tail(
        m, lr, kout_g, bout_g, layout="planar", halo="rows"),
        [a[:2] for a in gb_in])
    run_g_plain = rotating(lambda m, lr: pt.packed_tail_reference(
        m, lr, kout_g, bout_g), [a[:2] for a in g_in])
    g_call = time_ms(run_g, iters=10)
    g_ms = device_ms(run_g, kernel="packed_tail_map_kernel")
    gb_ms = device_ms(run_gb, kernel="packed_tail_map_kernel")
    g_in = [(m.to(torch.bfloat16), lr) for m, lr, _, _ in g_in]
    g_bf16_ms = device_ms(rotating(lambda m, lr: pt.packed_tail(
        m, lr, kout_g, bout_g, layout="planar"), g_in),
        kernel="packed_tail_map_kernel")
    g_plain = device_ms(run_g_plain, n=3, warmup=1)
    del g_in, gb_in
    torch.cuda.empty_cache()
    g_bound, g_by, g_bytes, g_flops = map_bound(h, w, 4, "zero")
    gb_bound, gb_by, _, _ = map_bound(hb, w, 4, "rows")
    g_bf16_bound, g_bf16_by, _, _ = map_bound(h, w, 4, "zero", m_bytes=2)
    shard_ms = {}
    for n in (2, 4):
        serve = lambda f, n=n: sp.learned_resize_spatial_sharded(
            up.model, up.params, f, 4, mesh=meshes[n])
        shard_ms[n] = (time_ms(lambda: serve(lr_dev), iters=5, runs=10),
                       time_ms(lambda: serve(frames[0]).cpu().numpy(),
                               runs=10))
    emit({"phase": "times_sharded", "card": name_power, "frame": [h, w, 4],
          "packed_tail_ms": g_ms, "packed_tail_band_of_4_ms": gb_ms,
          "packed_tail_bf16_ms": g_bf16_ms,
          "packed_tail_plain_ms_no_yardstick": g_plain,
          "per_call_ms_with_host_launch": {"packed_tail": g_call},
          "packed_tail_bytes": g_bytes, "packed_tail_flops": g_flops,
          "packed_tail_bound_ms": g_bound, "packed_tail_bound_by": g_by,
          "packed_tail_band_of_4_bound_ms": gb_bound,
          "packed_tail_band_of_4_bound_by": gb_by,
          "packed_tail_bf16_bound_ms": g_bf16_bound,
          "packed_tail_bf16_bound_by": g_bf16_by,
          "sharded_2_bands_call_device_ms": shard_ms[2][0],
          "sharded_2_bands_call_fetch_ms": shard_ms[2][1],
          "sharded_4_bands_call_device_ms": shard_ms[4][0],
          "sharded_4_bands_call_fetch_ms": shard_ms[4][1],
          "model_upscaler_call_device_ms": call_dev,
          "model_upscaler_call_fetch_ms": call_host})

    emit({"phase": "profile_sharded", "card": name_power, "bands": 4,
          **profile_served_frames(
              lambda f: sp.learned_resize_spatial_sharded(
                  up.model, up.params, f, 4, mesh=meshes[4]).cpu().numpy(),
              frames[0], 5, {
                  "packed_tail_ms_per_frame": "packed_tail_map_kernel",
                  "memcpy_dtoh_ms_per_frame": "Memcpy DtoH"})})

    # 6e. the direct-regression checkpoints through ModelUpscaler at the
    # learned path's 348x510 RGBA frame -> 1392x2040 RGB, f32 (cuDNN convs
    # with TF32 off; no TPU kernel lies on this path, and none of the seven
    # kernels may launch)
    from bicubic_interpolation_model_tpu_torch.models.inference import (
        super_resolve_direct)
    torch.cuda.empty_cache()
    crops = [f[:48, :64] for f in frames[:4]]
    direct_ups = {}
    for name in DIRECT:
        up_d = direct_ups[name] = ModelUpscaler(str(ROOT / "model" / name))
        heavy = name.startswith("esrgan")
        zero_counts()
        out = up_d(frames[0])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        up_d(lr_dev, fetch=False)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        launches_dir = read_counts()
        if out.shape != (FRAME[0] * 4, FRAME[1] * 4, 3) \
                or out.dtype != np.uint8 or float(out.std()) == 0:
            raise AssertionError(f"{name}: bad output {out.shape} "
                                 f"{out.dtype}")
        if any(launches_dir.values()):
            raise AssertionError(f"{name} launched a resize kernel: "
                                 f"{launches_dir}")
        runs = 3 if heavy else 5
        call_dev_ms = time_ms(lambda: up_d(lr_dev, fetch=False), runs=runs,
                              warmup=1)
        call_fetch_ms = time_ms(lambda: up_d(frames[0]), runs=runs, warmup=1)
        flops = direct_flops(up_d.model, *FRAME)
        n_params = sum(t.numel() for t in up_d.model.parameters())
        # 3 u8 in and 16 x 3 out per LR pixel, the f32 params read once
        d_bytes = FRAME[0] * FRAME[1] * (3 + 48) + n_params * 4
        d_bound, d_by = max((flops / F32_FLOP_PER_S * 1e3, "operations"),
                            (d_bytes / HBM_BYTES_PER_S * 1e3, "bytes"))
        prof = profile_served_frames(up_d, frames[0], 2, {}, ops={
            "cudnn_convolution_ms_per_frame": "aten::cudnn_convolution"})
        # float64 on the card: the same module, params and input cast
        f32 = [up_d(c) for c in crops]
        worst = (0, 0.0)
        for c, o in zip(crops, f32):
            ref = super_resolve_direct(
                up_d.model, up_d.params, torch.from_numpy(
                    np.ascontiguousarray(c[..., :3])).to(dev),
                compute_dtype=torch.float64)
            worst = max(worst, diff_u8(torch.from_numpy(o).to(dev), ref))
        batch2 = up_d.batch(np.stack(crops[:2]))
        batch_max = max(diff_u8(torch.from_numpy(b), torch.from_numpy(o))[0]
                        for b, o in zip(batch2, f32))
        streamed = list(up_d.stream(iter(crops)))
        stream_max = max(diff_u8(torch.from_numpy(a), torch.from_numpy(o))[0]
                         for a, o in zip(streamed, f32))
        res = {"phase": "direct_path", "card": name_power, "model": name,
               "frame": [*FRAME, 4], "out": list(out.shape),
               "launches": launches_dir,
               "call_device_ms": call_dev_ms, "call_fetch_ms": call_fetch_ms,
               "flops": flops, "mflop_per_lr_px": flops / FRAME[0] / FRAME[1]
               / 1e6, "bound_ms": d_bound, "bound_by": d_by,
               "share_of_f32_peak": d_bound / call_dev_ms if d_by ==
               "operations" else None,
               "peak_device_mb": peak / 2 ** 20,
               "cudnn_conv_share_of_device_busy":
                   prof["cudnn_convolution_ms_per_frame"]
                   / prof["device_busy_ms_per_frame"],
               "profile": prof,
               "vs_float64_crop": {"crop": [48, 64], "max": worst[0],
                                   "share": worst[1]},
               "batch_of_2_vs_calls_max": batch_max,
               "stream_in_order_vs_calls_max": stream_max,
               "stream_frames": len(streamed)}
        if name == "esrgan_plus":
            rgb_dev = lr_dev[..., :3].contiguous()
            bf = super_resolve_direct(up_d.model, up_d.params, rgb_dev,
                                      compute_dtype=torch.bfloat16)
            res["bf16"] = {
                "call_device_ms": time_ms(lambda: super_resolve_direct(
                    up_d.model, up_d.params, rgb_dev,
                    compute_dtype=torch.bfloat16), runs=3, warmup=1),
                "vs_f32": dict(zip(("max", "share"), diff_u8(
                    bf, up_d(lr_dev, fetch=False))))}
        emit(res)
        if worst[0] > 1 or worst[1] >= 1e-3 or batch_max > 1 \
                or stream_max > 1 or len(streamed) != len(crops):
            raise AssertionError(f"{name}: f32 vs float64 {worst}, batch "
                                 f"{batch_max}, stream {stream_max} "
                                 f"({len(streamed)} frames)")
        torch.cuda.empty_cache()

    # 6f. quality table: a synthetic 1392x2040 RGBA frame, downsampled 4x by
    # the port (lanczos3), rebuilt by thirteen methods and scored by the
    # port's metrics. The numbers describe this synthetic content only.
    from bicubic_interpolation_model_tpu_torch.evaluation.metrics import (
        compare_images)
    from bicubic_interpolation_model_tpu_torch.models.mlp_predictor import (
        load_mlp, super_resolve_mlp)
    from bicubic_interpolation_model_tpu_torch.ops.downsample import (
        downsample)
    hr = synthetic_hr(np.random.default_rng(30), FRAME[0] * 4, FRAME[1] * 4)
    lr = downsample(hr, 4.0, "lanczos3", device=dev).cpu().numpy()
    mlps = {n: load_mlp(ROOT / "model" / n, device=dev)
            for n in ("patch-mlp", "pixel-mlp")}
    zero_counts()
    rebuilt = {m: Upscaler(scale=4, method=m)(lr) for m in METHODS}
    rebuilt["adaptive"] = Upscaler(scale=4, method="adaptive")(lr)
    rebuilt["wp-1e-3-120"] = up(lr)
    for name in DIRECT:
        rebuilt[name] = direct_ups[name](lr)
    for name, (m, p, inc) in mlps.items():
        rebuilt[name] = super_resolve_mlp(m, p, lr, 4,
                                          include_offsets=inc).cpu().numpy()
    torch.cuda.synchronize()
    launches_q = read_counts()
    table = {}
    for method, img in rebuilt.items():
        if img.shape[:2] != hr.shape[:2]:
            raise AssertionError(f"quality_table {method}: {img.shape}")
        m = compare_images(hr, img)
        table[method] = {"psnr": m.psnr, "ssim": m.ssim, "mse": m.mse}
    emit({"phase": "quality_table", "card": name_power,
          "content": "synthetic (seeded gradients, edges, texture); the "
                     "numbers describe this frame, not image quality",
          "hr": list(hr.shape), "lr": list(lr.shape),
          "downsample": "lanczos3", "launches": launches_q,
          "methods": table})
    if len(table) != 13 or launches_q != {
            **{k: 0 for k in wrappers}, "resize_mxu": 4,
            "adaptive_resize_fused": 1, "packed_tail_fused": 1,
            "interleave_planar_u32": 1} or not all(
            15.0 < v["psnr"] < 100.0 for v in table.values()):
        raise AssertionError(f"quality_table: {launches_q} {table}")
    del rebuilt, direct_ups, mlps
    torch.cuda.empty_cache()

    # 6g. the bench (kernels C and D through the headline, F by parity)
    # and the CLI (A, B, C, E through sr-all; D, F through bench)
    bench_path(name_power, zero_counts, read_counts)
    cli_path(name_power, zero_counts, read_counts)
    torch.cuda.empty_cache()

    # 6h. the training slice (no TPU kernel lies on it; its last phase
    # serves what it trained through kernels A and B)
    train_path(dev, name_power, zero_counts, read_counts)

    # 6i. the labs: the probe instances of kernels D, E and G
    probe_entries = labs_path(dev, name_power)

    # 6j. the measurement scripts' paths: kernels C and D at the BASELINE
    # geometries, the latency curve, per-method throughput
    measurement_paths(dev, name_power, zero_counts, read_counts)

    # 6k. the serving policy: stream(microbatch="auto") groups as the
    # committed curves say, through kernels C, A and B
    serving_policy_path(name_power, zero_counts, read_counts)

    # 6l. the committed card record: each file fresh or stale, a row of
    # kernel C and one of kernel A re-timed beside their committed values
    results_path(dev, name_power, zero_counts, read_counts)

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
         "bound_by": "bytes", "library_ms": b_lib},
        {"name": "packed_tail", "route": "cuda",
         "source": "bicubic_interpolation_model_tpu_torch/csrc/"
                   "packed_tail_map.cu",
         "replaces": "bicubic_interpolation_model_tpu/ops/"
                     "pallas_packed_tail.py:50",
         "launches": launches_g["packed_tail"], "max_abs_err": g_err,
         "ms": g_ms, "plain_ms": g_plain, "bound_ms": g_bound,
         "bound_by": g_by, "library_ms": None},
        {"name": "resize_mxu", "route": "cuda",
         "source": "bicubic_interpolation_model_tpu_torch/csrc/resize_mxu.cu",
         "replaces": "bicubic_interpolation_model_tpu/ops/pallas_mxu.py:60",
         "launches": launches_cd["resize_mxu"], "max_abs_err": c_err,
         "ms": c_ms, "plain_ms": c_plain, "bound_ms": cd_bound,
         "bound_by": cd_by, "library_ms": lib_ms},
        {"name": "resize_phase", "route": "cuda",
         "source": "bicubic_interpolation_model_tpu_torch/csrc/"
                   "resize_phase.cu",
         "replaces": "bicubic_interpolation_model_tpu/ops/pallas_phase.py:49",
         "launches": launches_cd["resize_phase"], "max_abs_err": d_err,
         "ms": d_ms, "plain_ms": d_plain, "bound_ms": cd_bound,
         "bound_by": cd_by, "library_ms": lib_ms},
        {"name": "adaptive_resize_fused", "route": "cuda",
         "source": "bicubic_interpolation_model_tpu_torch/csrc/adaptive.cu",
         "replaces": "bicubic_interpolation_model_tpu/ops/"
                     "pallas_adaptive.py:105",
         "launches": launches_ef["adaptive_resize_fused"]
         + launches_gray["adaptive_resize_fused"],
         "max_abs_err": e_err, "ms": e_ms, "plain_ms": e_plain,
         "bound_ms": e_bound, "bound_by": e_by, "library_ms": None},
        {"name": "resize_banded", "route": "cuda",
         "source": "bicubic_interpolation_model_tpu_torch/csrc/"
                   "resize_banded.cu",
         "replaces": "bicubic_interpolation_model_tpu/ops/"
                     "pallas_resize.py:81",
         "launches": launches_ef["resize_banded"], "max_abs_err": f_err,
         "ms": f_ms, "plain_ms": f_plain_ms, "bound_ms": cd_bound,
         "bound_by": cd_by, "library_ms": lib_ms}] + probe_entries})
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
