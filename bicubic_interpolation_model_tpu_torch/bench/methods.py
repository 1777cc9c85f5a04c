"""Per-method throughput on the card.

Counterpart of the body of the JAX package's
``scripts/method_throughput.py`` (the framework's version of the
reference's 8-method ``cp_performance`` sweep); the script that runs it is
``scripts/torch_method_throughput.py`` and ``chip_smoke.py``'s
``method_throughput`` phase runs the sections no earlier phase covers
(``rational``, ``downsample``). The sections and geometries are the JAX
script's:

- ``classical``: nearest, bilinear, Lanczos, bicubic at 1080p -> 4x, the
  faster of kernels C and D within 1 u8 of the oracle (D's and, for
  bicubic, D planar's GPix/s beside it);
- ``adaptive``: kernel E at the reference's 0020 geometry (LR 348x510 ->
  4x; planar words, with the hwc and hwc32 program-output ms) against the
  plain graph, and at 1080p -> 4x;
- ``learned``: every committed WeightPredictor checkpoint
  (``model/wp-*``) at 348x510 -> 4x through kernel A, held to the plain
  graph tail (:func:`learned_row`). The JAX script's
  ``ref_1e-3-30`` row reads the reference's own checkpoint, which the
  repository does not hold; each row names the checkpoint it ran;
- ``neural``: the direct models (``model/espcn_*``, ``esrgan_*``,
  ``srresnet_tpu``; cuDNN convs) at 348x510 -> 4x;
- ``rational``: bicubic 1.5x and 2.5x at 1080p: kernel C, the plain
  phase graph and the plain matmul;
- ``downsample``: ``ops/downsample`` (lanczos3, bicubic) at the 0020 HR
  geometry and at 4K -> /4 (it builds its two matrices on the host at
  every call: they are in the time);
- ``train``: weight-predictor training steps, image mode (one 352x512
  bucket) and patch mode (16 x 48x48).

Each resize row's output of the input it times is held to the float64
oracle (the adaptive rows to the adaptive oracle): every 67th row of
outputs taller than 4096 rows, every row otherwise. Each row counts the
seven kernels' launches over one call (``launches``) beside those it
should make (``expected_launches``). ``reference_ms`` and ``speedup``
compare with the reference's JS wall-clock (``cp_performance``). Times
come from the suite's CUDA-event slopes (``chained_bench``,
``bench_resize_ondevice``, ``bench_program_output``) over inputs rotated
past the L2, with each kernel's plans and weights kept across calls as the
serving classes keep them. On the CPU the sections run once at
:data:`SMALL` shapes and nothing is timed.
"""

from __future__ import annotations

import dataclasses
import pathlib

import numpy as np
import torch

from . import configs, suite

ROOT = pathlib.Path(__file__).resolve().parents[2]

#: the reference's wall-clock (ms, best run) from cp_performance/*/*.csv,
#: as the JAX script holds it
REFERENCE_MS = {
    "nearest": 30.1, "bilinear": 137.6, "bicubic": 7312.6, "lanczos": 6807.9,
    "adaptive_bicubic": 26848.6, "model_1e-3-30": 7580.3,
    "espcn_medium": 2452.6, "espcn_thick": 16434.1,
}
LR_H, LR_W, SCALE = 348, 510, 4   # image 0020 geometry
SECTIONS = ("classical", "adaptive", "learned", "neural", "rational",
            "train", "downsample")
CLASSICAL = ("nearest", "bilinear", "lanczos", "bicubic")
#: the direct models and the reference row each compares with
NEURAL = (("espcn_medium", "espcn_medium"), ("espcn_thick", "espcn_thick"),
          ("esrgan_lite", "espcn_thick"), ("esrgan_plus", "espcn_thick"),
          ("srresnet_tpu", "espcn_thick"))
RATIONAL_IMPLS = ("pallas_mxu", "phase", "matmul")


@dataclasses.dataclass(frozen=True)
class Geometry:
    """The shapes the sections run at."""
    hd: tuple                 # classical, rational, adaptive 1080p
    lr: tuple                 # the 0020 LR frame
    downsample: tuple         # (label, (rows, columns)) per HR frame
    train_image: tuple        # LR bucket of the image step
    train_patch: tuple        # (batch, LR patch)


FULL = Geometry((1080, 1920), (LR_H, LR_W),
                (("downsample_0020_4x", (1392, 2040)),
                 ("downsample_4k_4x", (2160, 3840))),
                (352, 512), (16, 48))
SMALL = Geometry((24, 40), (20, 28),
                 (("downsample_0020_4x", (64, 96)),
                  ("downsample_4k_4x", (72, 128))),
                 (16, 24), (2, 8))

#: the kernel each kernel impl launches, once per call
OWN_KERNEL = {"pallas_mxu": "resize_mxu", "pallas_phase": "resize_phase",
              "pallas_phase_planar": "resize_phase",
              "pallas": "adaptive_resize_fused"}


def expected_launches(impl) -> dict:
    """One launch of ``impl``'s kernel, none of the others (none at all
    for a plain graph)."""
    own = OWN_KERNEL.get(impl)
    return configs.expected(**({own: 1} if own else {}))


def resize_row(h, w, scale, method, impl, *, dev):
    """``suite.bench_resize_ondevice``'s row of ``impl`` (None times on the
    CPU) with the launches of one call on its seeded input and that
    call's output held to the float64 oracle (every 67th row of outputs
    taller than 4096 rows, every row otherwise)."""
    img = suite._make_input(h, w)
    x = torch.from_numpy(img).to(dev)
    fn = suite._resize_for_impl(impl, scale, method, {})
    got, launches = configs.counted(lambda: fn(x))
    if impl == "pallas_phase_planar":
        from ..ops.phase import interleave_planar
        got = interleave_planar(got[None], h, w, int(scale), img.shape[-1])[0]
    case = suite.parity_case(img, scale, got)
    del got, x
    row = (suite.bench_resize_ondevice(h, w, scale, method, impl=impl,
                                       device=dev)
           if dev.type == "cuda"
           else configs.untimed_row(h, w, scale, method, impl))
    row["launches"] = launches
    row["expected_launches"] = expected_launches(impl)
    row["max_u8_delta"] = suite.oracle_deltas([case], method)[0]
    return row


def _best(rows):
    ok = [r for r in rows if r["max_u8_delta"] <= 1] or rows
    return max(ok, key=lambda r: r["gpix_per_s"] or 0.0)


def classical(out, *, geo, dev, emit):
    h, w = geo.hd
    for method in CLASSICAL:
        cands = [resize_row(h, w, 4, method, impl, dev=dev)
                 for impl in configs.SINGLE_IMPLS]
        row = dict(_best(cands), geometry="1080p->4x")
        row["phase_hwc_gpix_per_s"] = cands[1]["gpix_per_s"]
        row["candidates"] = {c["impl"]: c for c in cands}
        if method == "bicubic":
            rp = resize_row(h, w, 4, method, "pallas_phase_planar", dev=dev)
            row["planar_gpix_per_s"] = rp["gpix_per_s"]
            row["candidates"]["pallas_phase_planar"] = rp
        out[method] = row
        emit(method, row)


def _timed_or_none(dev, timer, *args, **kw):
    return timer(*args, **kw) if dev.type == "cuda" else None


def planar_words_to_hwc(words, c):
    """Kernel E's ``layout="planar"`` words, uint32 [S, H*S, W] (word
    ``(px, r, X)`` holds output pixel ``(r, X*S + px)``), as uint8 HWC
    [H*S, W*S, C]."""
    s, rows, w = words.shape
    u8 = words.contiguous().view(torch.uint8).reshape(s, rows, w, 4)[..., :c]
    return u8.permute(1, 2, 0, 3).reshape(rows, w * s, c)


def adaptive_delta(img, got):
    """Max u8 delta of ``got`` (HWC, any device), kernel E's or the plain
    graph's output of the host frame ``img`` at :data:`SCALE`, from the
    adaptive oracle: every 67th row of outputs taller than 4096 rows,
    every row otherwise (``suite.parity_rows``)."""
    from ..core.oracle import adaptive_bicubic_oracle
    rows = suite.parity_rows(got.shape[0])
    want = adaptive_bicubic_oracle(img, float(SCALE), rows=rows)
    sel = got.index_select(0, torch.from_numpy(rows).to(got.device))
    return int(np.abs(sel.cpu().numpy().astype(np.int64)
                      - want.astype(np.int64)).max())


def adaptive(out, lr_u8, rng, *, geo, dev, emit):
    from ..ops.adaptive import adaptive_resize
    from ..ops.adaptive_fused import adaptive_resize_fused
    lr_np = lr_u8.cpu().numpy()
    c = lr_np.shape[-1]
    out_px = lr_u8.shape[0] * lr_u8.shape[1] * SCALE * SCALE
    best = None
    cache: dict = {}    # the kernel's weights, kept as Upscaler keeps them
    for impl in ("pallas", "jnp"):
        if impl == "pallas":
            fn = lambda x: adaptive_resize_fused(
                x, SCALE, -0.5, layout="planar", weight_cache=cache)
            fn_hwc = lambda x: adaptive_resize_fused(x, SCALE, -0.5,
                                                     weight_cache=cache)
            fn_hwc32 = lambda x: adaptive_resize_fused(
                x, SCALE, -0.5, layout="hwc32", weight_cache=cache)
        else:
            fn = fn_hwc = lambda x: adaptive_resize(x, SCALE, -0.5,
                                                    impl="jnp",
                                                    device=x.device)
        got, launches = configs.counted(lambda: fn(lr_u8))
        if impl == "pallas":
            got = planar_words_to_hwc(got, c)
        delta = adaptive_delta(lr_np, got)
        del got
        per = _timed_or_none(dev, suite.chained_bench, fn, lr_u8)
        row = {"ms_per_frame": configs.to_ms(per),
               "gpix_per_s": None if per is None else out_px / per / 1e9,
               "impl": impl,
               "layout": "planar_u32" if impl == "pallas" else "hwc",
               "hwc_program_output_ms": configs.to_ms(_timed_or_none(
                   dev, suite.bench_program_output, fn_hwc, lr_u8)),
               "reference_ms": REFERENCE_MS["adaptive_bicubic"],
               "speedup": None if per is None
               else REFERENCE_MS["adaptive_bicubic"] / (per * 1e3),
               "launches": launches,
               "expected_launches": expected_launches(impl),
               "max_u8_delta": delta}
        if impl == "pallas":
            row["hwc32_program_output_ms"] = configs.to_ms(_timed_or_none(
                dev, suite.bench_program_output, fn_hwc32, lr_u8))
        emit("adaptive_bicubic_0020", row)
        if best is None or (row["gpix_per_s"] or 0.0) > (
                best["gpix_per_s"] or 0.0):
            best = row
    out["adaptive_bicubic_0020"] = best
    hd_np = rng.integers(0, 256, (*geo.hd, 4), dtype=np.uint8)
    hd = torch.from_numpy(hd_np).to(dev)
    fn = lambda x: adaptive_resize_fused(x, 4, -0.5, layout="planar",
                                         weight_cache=cache)
    got, launches = configs.counted(lambda: fn(hd))
    delta = adaptive_delta(hd_np, planar_words_to_hwc(got, 4))
    del got
    per = _timed_or_none(dev, suite.chained_bench, fn, hd)
    out["adaptive_bicubic_1080p"] = {
        "ms_per_frame": configs.to_ms(per),
        "gpix_per_s": None if per is None
        else geo.hd[0] * geo.hd[1] * 16 / per / 1e9,
        "impl": "pallas", "layout": "planar_u32", "geometry": "1080p->4x",
        "launches": launches, "expected_launches": expected_launches("pallas"),
        "max_u8_delta": delta}
    emit("adaptive_bicubic_1080p", out["adaptive_bicubic_1080p"])


def rational(out, *, geo, dev, emit):
    h, w = geo.hd
    for scale in (1.5, 2.5):
        rows = {impl: resize_row(h, w, scale, "bicubic", impl, dev=dev)
                for impl in RATIONAL_IMPLS}
        for impl, r in rows.items():
            emit(f"bicubic_{scale}x_{impl}", r)
        primary = _best(list(rows.values()))["impl"]
        out[f"bicubic_{scale}x_1080p"] = {
            "geometry": f"1080p->{scale}x", **rows[primary],
            "impl": primary,
            **{f"{k}_gpix_per_s": v["gpix_per_s"] for k, v in rows.items()},
            "candidates": rows}


def learned_row(d, lr_u8, *, dev) -> dict:
    """The row of the WeightPredictor checkpoint in directory ``d`` on
    ``lr_u8``: its launches over one call, that call's output held to the
    plain graph tail (``max_u8_delta``; the learned contract is ≤1 u8)
    and, on the card, its chained and program-output times."""
    from ..evaluation.model_analysis import _load_model_any
    from ..models.inference import _tail_operands, _tree, super_resolve
    out_px = lr_u8.shape[0] * lr_u8.shape[1] * SCALE * SCALE
    model, params = _load_model_any(d, device=dev)
    # the tail's operands, built once per checkpoint as ModelUpscaler
    # builds them
    with torch.no_grad():
        ops = _tail_operands(_tree(params), SCALE, "train")
    fn = lambda x: super_resolve(model, params, x, SCALE, "train",
                                 tail_operands=ops)
    got, launches = configs.counted(lambda: fn(lr_u8))
    graph = super_resolve(model, params, lr_u8, SCALE, "train",
                          tail="graph")
    delta = int((got.to(torch.int16) - graph.to(torch.int16)).abs().max())
    del got, graph
    per = _timed_or_none(dev, suite.chained_bench, fn, lr_u8)
    po = _timed_or_none(dev, suite.bench_program_output, fn, lr_u8)
    ref = REFERENCE_MS["model_1e-3-30"]
    return {
        "ms_per_frame": configs.to_ms(per),
        "program_output_ms": configs.to_ms(po),
        "gpix_per_s": None if per is None else out_px / per / 1e9,
        "reference_ms": ref,
        "speedup": None if per is None else ref / (per * 1e3),
        "impl": "packed forward (cuDNN convs), fused tail kernel A "
                "(csrc/packed_tail.cu)",
        "note": "phase-packed predict+apply; the reference row is its "
                "own 1e-3-30 checkpoint, this one the committed "
                f"model/{d.name}",
        "checkpoint": f"model/{d.name}", "launches": launches,
        "expected_launches": configs.expected(packed_tail_fused=1),
        "max_u8_delta": delta}


def learned(out, lr_u8, *, dev, emit):
    for d in sorted((ROOT / "model").glob("wp-*")):
        out[d.name] = learned_row(d, lr_u8, dev=dev)
        emit(d.name, out[d.name])


def neural(out, lr_u8, *, dev, emit):
    from ..evaluation.model_analysis import _load_model_any
    from ..models.inference import _apply_direct
    out_px = lr_u8.shape[0] * lr_u8.shape[1] * SCALE * SCALE
    lr_f = lr_u8[..., :3].float() / 255.0
    for name, ref_key in NEURAL:
        d = ROOT / "model" / name
        if not d.exists():
            continue
        model, params = _load_model_any(d, device=dev)
        fn = lambda x: _apply_direct(model, params, x[None],
                                     torch.float32)[0]
        _, launches = configs.counted(lambda: fn(lr_f))
        per = _timed_or_none(dev, suite.chained_bench, fn, lr_f)
        po = _timed_or_none(dev, suite.bench_program_output, fn, lr_f)
        ref = REFERENCE_MS[ref_key]
        out[name] = {
            "ms_per_frame": configs.to_ms(per),
            "program_output_ms": configs.to_ms(po),
            "gpix_per_s": None if per is None else out_px / per / 1e9,
            "reference_ms": ref,
            "speedup": None if per is None else ref / (per * 1e3),
            "checkpoint": f"model/{name}", "launches": launches,
            "expected_launches": configs.expected()}
        emit(name, out[name])


def downsample(out, rng, *, geo, dev, emit):
    from ..ops.downsample import downsample as ds
    for label, (hh, ww) in geo.downsample:
        hr = torch.from_numpy(rng.integers(0, 256, (hh, ww, 4),
                                           dtype=np.uint8)).to(dev)
        for filt in ("lanczos3", "bicubic"):
            fn = lambda x, f=filt: ds(x, float(SCALE), f, device=x.device)
            _, launches = configs.counted(lambda: fn(hr))
            per = _timed_or_none(dev, suite.chained_bench, fn, hr)
            row = {"ms_per_frame": configs.to_ms(per),
                   "in_mpix_per_s": None if per is None
                   else hh * ww / per / 1e6,
                   "filter": filt, "geometry": f"{hh}x{ww}->/4",
                   "launches": launches,
                   "expected_launches": configs.expected()}
            out[f"{label}_{filt}"] = row
            emit(f"{label}_{filt}", row)


def train(out, rng, *, geo, dev, emit):
    from ..models.weight_predictor import WeightPredictor
    from ..ops.learned import gt_weight_map, offset_map
    from ..train.trainer import adam, fresh_params, \
        make_weight_predictor_step
    model = WeightPredictor(scale=SCALE)
    params = fresh_params(model, dev, seed=0)
    opt = adam(1e-4).init(params)
    step = make_weight_predictor_step(model, scale=SCALE)

    def bench_train(b, h, w, label):
        img = torch.from_numpy(rng.random((b, h, w, 4),
                                          dtype=np.float32)).to(dev)
        hs, ws = h * SCALE, w * SCALE
        off = offset_map(hs, ws, float(SCALE), "train",
                         device=dev)[None].expand(b, hs, ws, 2)
        y = gt_weight_map(hs, ws, float(SCALE),
                          device=dev)[None].expand(b, hs, ws, 16)
        mask = torch.ones((b, hs, ws, 1), device=dev)
        fn = lambda x: step(params, opt, x, off, y, mask)[2]
        fn(img)
        per = _timed_or_none(dev, suite.chained_bench, fn, img, k_lo=2,
                             k_hi=12)
        row = {"ms_per_step": configs.to_ms(per),
               "images_per_s": None if per is None else b / per,
               "lr_mpix_per_s": None if per is None
               else b * h * w / per / 1e6,
               "geometry": f"{b}x{h}x{w} LR"}
        out[label] = row
        emit(label, row)

    bench_train(1, *geo.train_image, "train_step_image_0020")
    b, p = geo.train_patch
    bench_train(b, p, p, "train_step_patch16x48")


def lr_frame(rng, geo, dev) -> torch.Tensor:
    """The seeded RGBA frame at ``geo.lr`` of the adaptive, learned and
    neural rows (the first draw of :func:`run`'s ``default_rng(0)``)."""
    return torch.from_numpy(rng.integers(0, 256, (*geo.lr, 4),
                                         dtype=np.uint8)).to(dev)


def run(sections, *, geo=FULL, dev, card="", emit=None) -> dict:
    """The ``sections`` (names of :data:`SECTIONS`): their rows by the JAX
    script's keys, each stamped with the card. ``emit(name, row)`` gets
    each row."""
    out = {}
    unknown = set(sections) - set(SECTIONS)
    if unknown:
        raise ValueError(f"unknown sections {sorted(unknown)}")
    stamp = lambda name, row: (row.__setitem__("card", card),
                               emit and emit(name, row))
    kw = dict(dev=dev, emit=stamp)
    rng = np.random.default_rng(0)
    lr_u8 = lr_frame(rng, geo, dev)
    for section in SECTIONS:
        if section not in sections:
            continue
        if section == "classical":
            classical(out, geo=geo, **kw)
        elif section == "adaptive":
            adaptive(out, lr_u8, rng, geo=geo, **kw)
        elif section == "learned":
            learned(out, lr_u8, **kw)
        elif section == "neural":
            neural(out, lr_u8, **kw)
        elif section == "rational":
            rational(out, geo=geo, **kw)
        elif section == "downsample":
            downsample(out, rng, geo=geo, **kw)
        else:
            train(out, rng, geo=geo, **kw)
    return out


def failures(out: dict, on_card: bool) -> list:
    """What fails among ``out``'s rows and their candidates: a delta above
    1 u8 from the oracle, and on the card launches of the seven kernels
    other than the row's ``expected_launches``."""
    bad = []
    for name, row in out.items():
        subs = [(name, row)] + [(f"{name} {k}", c) for k, c in
                                row.get("candidates", {}).items()]
        for label, r in subs:
            delta = r.get("max_u8_delta")
            if delta is not None and delta > 1:
                bad.append(f"{label}: max_u8_delta {delta}")
            if on_card and "expected_launches" in r \
                    and r["launches"] != r["expected_launches"]:
                bad.append(f"{label}: launches {r['launches']}, expected "
                           f"{r['expected_launches']}")
    return bad
