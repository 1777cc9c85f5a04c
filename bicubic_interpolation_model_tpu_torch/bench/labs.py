"""The kernel labs: probe instances of kernels D, E and G beside their
production instances, each held to its plain version.

Counterparts of the JAX package's labs (``scripts/kernel_lab.py``,
``packed_tail_lab.py``, ``adaptive_probe_lab.py``, ``adaptive_lab.py``),
whose Pallas probes are cut-down copies of a shipped kernel. Here a probe
is an instance of the production kernel's own template with one stage cut
or replaced (``csrc/resize_phase.cu``, ``adaptive.cu``,
``packed_tail_map.cu``): the same grid, staging and stores, so the time
between a probe and the full instance is the time of what it cut. A
:class:`Case` runs one instance through its wrapper and knows its plain
version, its tolerance and the TPU lab line it replaces; the scripts
``scripts/torch_*_lab.py`` time the cases on the card and
``chip_smoke.py``'s ``labs`` phase checks and times them once. The lab
inputs (seeded frames) and the scripts' common scaffolding (device, the
card's name and power limit, rows, the table) live here too.

Tolerances, instance vs plain version on the same inputs: uint8 outputs
within 1 LSB with a share of differing bytes below 1e-3 (the kernels' own
contract: FMA contraction, the factored order and approximate ``ex2`` and
reciprocal in E, tensor-core sums in G), within 2 LSB for kernel G on a
bf16 map (its production contract); kernel G's float stage sums
(``matmul``, ``tanh``) within 1e-3 of the plain sum relative
to ``max(1, |sum|)`` (3xTF32 products keep ~21 bits, bf16 products are
exact, both summed in another order over 288 products a weight).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import subprocess
from typing import Callable

import numpy as np
import torch

from ..ops import adaptive_fused as adf
from ..ops import packed_tail as pt
from ..ops import phase

CSRC = "bicubic_interpolation_model_tpu_torch/csrc/"
#: where the lab scripts write their tables (git ignores build/)
LAB_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "labs"

#: the TPU lab function each probe replaces (file:line)
REPLACES = {
    "rowonly": "scripts/kernel_lab.py:213",
    "null": "scripts/kernel_lab.py:232",
    "chw": "scripts/kernel_lab.py:409",
    "law_scratch": "scripts/adaptive_probe_lab.py:55",
    "law_const": "scripts/adaptive_probe_lab.py:55",
    "fma_only": "scripts/adaptive_probe_lab.py:55",
    "nolaw": "scripts/adaptive_lab.py:108",
    "noeq": "scripts/adaptive_lab.py:117",
    "matmul": "scripts/packed_tail_lab.py:76",
    "tanh": "scripts/packed_tail_lab.py:76",
    "apply": "scripts/packed_tail_lab.py:76",
}
#: the kernel function each lab kernel's instances are named by in a
#: profiler trace (``chip_smoke.device_ms(kernel=...)``)
SYMBOLS = {"D": "resize_phase_kernel", "E": "adaptive_kernel",
           "G": "packed_tail_map_kernel"}

U8_TOL = (1, 1e-3)          # max LSB, share of differing bytes below
REL_TOL = 1e-3              # kernel G's float stage sums


@dataclasses.dataclass
class Case:
    """One instance of a lab: ``run(x)`` launches it through its wrapper,
    ``plain(x)`` is its plain version, ``check(got, ref)`` gives (the
    largest deviation, whether it is within the tolerance), ``launches()``
    reads the wrapper's count for this instance; ``symbol`` names its
    kernel function (:data:`SYMBOLS`)."""
    lab: str
    name: str
    kernel: str
    probe: str
    source: str
    replaces: str | None
    x: torch.Tensor
    run: Callable
    plain: Callable
    check: Callable
    launches: Callable

    @property
    def symbol(self) -> str:
        return SYMBOLS[self.kernel]


def check_u8(got, ref):
    """(max |got - ref| over the bytes, within ``U8_TOL``)."""
    a = got.contiguous().view(torch.uint8).to(torch.int16)
    b = ref.contiguous().view(torch.uint8).to(torch.int16)
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} vs {tuple(b.shape)}")
    d = (a - b).abs()
    mx, share = int(d.max()), float((d != 0).double().mean())
    return mx, mx <= U8_TOL[0] and share < U8_TOL[1]


def check_u8_bf16(got, ref):
    """(max |got - ref| over the bytes, within 2): kernel G on a bf16
    map."""
    mx, _ = check_u8(got, ref)
    return mx, mx <= 2


def check_rel(got, ref):
    """(max |got - ref| / max(1, |ref|), within ``REL_TOL``)."""
    if got.shape != ref.shape:
        raise AssertionError(f"shape {tuple(got.shape)} vs "
                             f"{tuple(ref.shape)}")
    err = float(((got.float() - ref.float()).abs()
                 / ref.float().abs().clamp(min=1.0)).max())
    return err, err <= REL_TOL


def d_cases(x, weight_cache=None):
    """Kernel D at 4x bicubic on uint8 RGBA ``x`` [B, H, W, 4]: the full
    instance (hwc, planar) and the probes ``rowonly`` and ``null`` (hwc,
    planar) and ``chw``."""
    cache = {} if weight_cache is None else weight_cache
    h, w = x.shape[1:3]
    wrow, wcol, taps, left = phase._weights("bicubic", h, w, 4, -0.5, 3,
                                            x.device, cache)[:4]
    cases = []
    for probe, layout in (("full", "hwc"), ("full", "planar"),
                          ("rowonly", "hwc"), ("rowonly", "planar"),
                          ("null", "hwc"), ("null", "planar"),
                          ("chw", "hwc")):
        suffix = "_planar" if layout == "planar" else ""
        if probe == "full":
            name = "resize_phase" + suffix
            run = (lambda t, layout=layout: phase.resize_phase(
                t, 4, layout=layout, weight_cache=cache))
            count = lambda: phase.resize_phase.launches
        else:
            name = f"resize_phase_probe_{probe}{suffix}"
            run = (lambda t, probe=probe, layout=layout:
                   phase.resize_phase_probe(t, 4, probe, layout=layout,
                                            weight_cache=cache))
            count = (lambda key=probe + suffix:
                     phase.resize_phase_probe.launches[key])
        cases.append(Case(
            "kernel_lab", name, "D", probe, CSRC + "resize_phase.cu",
            REPLACES.get(probe), x, run,
            lambda t, probe=probe, layout=layout:
                phase.resize_phase_reference(t, wrow, wcol, 4, taps, left,
                                             layout, probe=probe),
            check_u8, count))
    return cases


def e_cases(frames, weight_cache=None):
    """Kernel E at 4x on each uint8 frame of ``frames`` ([B, H, W, C], C = 4
    or 1), planar as the TPU labs time it: the full instance and the five
    probes."""
    cache = {} if weight_cache is None else weight_cache
    cases = []
    for x in frames:
        c = x.shape[-1]
        suffix = "" if c == 4 else f"_c{c}"
        wts = adf._weights(x.shape[1], x.shape[2], 4, -0.5, x.device, cache)
        for probe in ("full", *adf.PROBES):
            lab = ("adaptive_lab" if probe in ("nolaw", "noeq")
                   else "adaptive_probe_lab")
            if probe == "full":
                name = "adaptive_resize_fused" + suffix
                run = (lambda t: adf.adaptive_resize_fused(
                    t, 4, layout="planar", weight_cache=cache))
                count = lambda: adf.adaptive_resize_fused.launches
            else:
                name = f"adaptive_probe_{probe}{suffix}"
                run = (lambda t, probe=probe: adf.adaptive_probe(
                    t, 4, probe, layout="planar", weight_cache=cache))
                count = (lambda key=probe + suffix:
                         adf.adaptive_probe.launches[key])
            cases.append(Case(
                lab, name, "E", probe, CSRC + "adaptive.cu",
                REPLACES.get(probe), x, run,
                lambda t, probe=probe, wts=wts: adf.adaptive_resize_reference(
                    t, *wts, 4, layout="planar", probe=probe),
                check_u8, count))
    return cases


def g_cases(m, lr, kout, bout):
    """Kernel G on the merged map ``m`` [h, w, 4, 4, 32] (f32; the bf16
    cases take it rounded) and the LR pixels ``lr`` [h, w, c]: the full
    instance and the stage probes, planar, f32 and bf16 maps."""
    cases = []
    for dname, mm in (("f32", m), ("bf16", m.to(torch.bfloat16))):
        for probe in ("full", *pt.PROBES):
            if probe == "full":
                name = f"packed_tail_{dname}"
                run = (lambda t: pt.packed_tail(t, lr, kout, bout,
                                                layout="planar"))
                plain = (lambda t: pt.packed_tail_reference(t, lr, kout,
                                                            bout))
                count = lambda: pt.packed_tail.launches
            else:
                name = f"packed_tail_probe_{probe}_{dname}"
                run = (lambda t, probe=probe: pt.packed_tail_probe(
                    t, lr, kout, bout, probe))
                plain = (lambda t, probe=probe:
                         pt.packed_tail_probe_reference(t, lr, kout, bout,
                                                        probe))
                count = (lambda key=f"{probe}_{dname}":
                         pt.packed_tail_probe.launches[key])
            float_sum = probe in ("matmul", "tanh")
            cases.append(Case(
                "packed_tail_lab", name, "G", probe,
                CSRC + "packed_tail_map.cu", REPLACES.get(probe), mm, run,
                plain, check_rel if float_sum else
                check_u8_bf16 if dname == "bf16" else check_u8, count))
    return cases


def zero_counts():
    """Set every probe's launch count to 0."""
    for fn in (phase.resize_phase_probe, adf.adaptive_probe,
               pt.packed_tail_probe):
        for k in fn.launches:
            fn.launches[k] = 0


def read_counts():
    """The probes' launch counts, by kernel."""
    return {"D": dict(phase.resize_phase_probe.launches),
            "E": dict(adf.adaptive_probe.launches),
            "G": dict(pt.packed_tail_probe.launches)}


def stage_deltas(ms: dict, order: list) -> dict:
    """Consecutive differences of ``ms`` along ``order`` (names of rows
    from the cheapest to the full instance): the time each added stage
    costs."""
    return {f"{b} - {a}": ms[b] - ms[a] for a, b in zip(order, order[1:])}


def run_cases(cases, timer=None, emit=print) -> dict:
    """Each case once against its plain version (raises on a deviation
    beyond its tolerance), then ``timer(fn, x)`` (seconds per call) of the
    instance when given. Returns {name: row}; ``emit`` gets each row."""
    rows = {}
    for case in cases:
        got = case.run(case.x)
        if case.x.is_cuda:
            torch.cuda.synchronize()
        err, ok = case.check(got, case.plain(case.x))
        if not ok:
            raise AssertionError(f"{case.name} ({case.probe}) deviates from "
                                 f"its plain version: {err}")
        del got
        row = {"lab": case.lab, "name": case.name, "kernel": case.kernel,
               "probe": case.probe, "replaces": case.replaces,
               "max_abs_err": err,
               "ms": timer(case.run, case.x) * 1e3 if timer else None}
        rows[case.name] = row
        emit(row)
    return rows


def u8_frames(rng, *shape):
    """Uniform uint8 noise of ``shape`` from the numpy generator ``rng``."""
    return rng.integers(0, 256, shape, dtype=np.uint8)


def all_class_frames(rng, b, h, w, c):
    """[b, h, w, c] u8 frames that reach all three region classes of
    adaptive bicubic and both variance thresholds: quadrants of a constant
    (flat), a slow gradient (texture), low-amplitude noise (flat and
    texture) and full noise (edge), under a band of step edges; alpha
    varies."""
    yy, xx = np.mgrid[:h, :w]
    out = u8_frames(rng, b, h, w, c)
    h2, w2 = h // 2, w // 2
    out[:, :h2, :w2] = 97
    out[:, :h2, w2:] = ((40 + 2.2 * xx + 1.3 * yy) % 256).astype(
        np.uint8)[None, :h2, w2:, None]
    out[:, h2:, :w2] = rng.integers(114, 127, (b, h - h2, w2, c),
                                    dtype=np.uint8)
    out[:, h // 4:h // 4 + max(1, h // 8)] = np.where(
        (xx // max(1, w // 6)) % 2 == 0, 60, 180).astype(
        np.uint8)[None, h // 4:h // 4 + max(1, h // 8), :, None]
    if c == 4:
        out[..., 3] = u8_frames(rng, b, h, w)
    return out


def emit(obj):
    """``obj`` as one JSON line on standard output."""
    print(json.dumps(obj), flush=True)


def card() -> str:
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else "nvidia-smi unavailable"


def lab_parser(size: bool = True) -> argparse.ArgumentParser:
    """The lab scripts' common arguments: ``--cpu`` and, with ``size``,
    the frame ``--h`` x ``--w`` (1080x1920)."""
    ap = argparse.ArgumentParser()
    if size:
        ap.add_argument("--h", type=int, default=1080)
        ap.add_argument("--w", type=int, default=1920)
    ap.add_argument("--cpu", action="store_true",
                    help="check the plain versions on the CPU; time nothing")
    return ap


def lab_device(cpu: bool) -> tuple[torch.device, str]:
    """(the device, the card's name and power limit): the card, or the CPU
    when asked (plain versions, no times); without a card and without
    ``cpu`` it raises."""
    if cpu:
        return torch.device("cpu"), "cpu (no card: nothing measured)"
    if not torch.cuda.is_available():
        raise RuntimeError("these scripts run on the card: no CUDA device "
                           "is visible (pass --cpu to run the plain "
                           "versions)")
    return torch.device("cuda"), card()


def row_emitter(card_name: str, out_pix: int | None = None,
                rows: list | None = None) -> Callable:
    """A function that stamps a row with the card and, given the output
    pixels per call, the GPix/s of its ``ms``, emits it and appends it to
    ``rows``."""
    def emit_row(row):
        row["card"] = card_name
        if out_pix and row.get("ms") is not None:
            row["gpix_per_s"] = out_pix / row["ms"] / 1e6
        emit(row)
        if rows is not None:
            rows.append(row)
    return emit_row


def write_table(lab: str, table: dict) -> pathlib.Path:
    """``table`` as ``build/labs/<lab>.json``; says where, with the card."""
    LAB_DIR.mkdir(parents=True, exist_ok=True)
    path = LAB_DIR / f"{lab}.json"
    path.write_text(json.dumps(table, indent=1))
    print(f"wrote build/labs/{path.name} ({table.get('card')})", flush=True)
    return path
