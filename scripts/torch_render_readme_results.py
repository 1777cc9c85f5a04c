#!/usr/bin/env python3
"""Render README's "Measured results on the card" subsection from the
committed ``results_torch/`` tables, so that every card number the README
states traces to a stamped file.

    python3 scripts/torch_render_readme_results.py          # rewrite in place
    python3 scripts/torch_render_readme_results.py --check  # 1 if it differs

Counterpart of ``scripts/render_readme_results.py`` (the TPU section). The
subsection lies in the port's README section between its own markers
(:data:`BEGIN`, :data:`END`, which hold no text of the TPU section's
markers); the rest of README is left as it is. Each table names its file;
the numbers are the files' own, rounded to four significant digits
(:func:`num`), medians of the three latency-curve calls being one call's
value. ``tests/test_torch_results_consistency.py`` fails when README
differs from what this script renders. The quality table waits for the
DIV2K HR images, which the repository does not hold. Imports nothing of
JAX.
"""

from __future__ import annotations

import argparse
import json
import math
import pathlib
import statistics
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from bicubic_interpolation_model_tpu_torch.bench import (  # noqa: E402
    configs, methods)

BEGIN = ("<!-- torch-results:begin (generated by "
         "scripts/torch_render_readme_results.py) -->")
END = "<!-- torch-results:end -->"
LEARNED_ROWS = ("wp-1e-3-120", "wp-adaptive-1e-3-120")
#: the reference's output pixels per frame (image 0020, 348x510 -> 4x)
REF_OUT_PX = methods.LR_H * methods.LR_W * methods.SCALE ** 2


def num(x, sig: int = 4) -> str:
    """``x`` to ``sig`` significant digits, in fixed point."""
    if x is None:
        return "not measured"
    if x == 0:
        return "0"
    places = max(0, sig - 1 - math.floor(math.log10(abs(x))))
    return f"{x:,.{places}f}"


def load(name: str) -> dict:
    return json.loads((configs.CARD_RESULTS_DIR / name).read_text())


def _distinct(tables, key):
    return ", ".join(sorted({t["_provenance"][key] for t in tables}))


def header(tables: list) -> list:
    dates = sorted(t["_provenance"]["date"] for t in tables)
    shas = sorted({t["_provenance"]["source_sha256"][:12] for t in tables})
    return [
        f"Every number below is read from the committed, stamped tables in "
        f"`results_torch/`, one run of `scripts/torch_refresh_results.py` "
        f"on **{_distinct(tables, 'card')}** (torch "
        f"{_distinct(tables, 'torch')}, CUDA {_distinct(tables, 'cuda')}, "
        f"`source_sha256` {', '.join(f'`{s}`' for s in shas)}, "
        f"{_distinct(tables, 'commit')}, {dates[0]} to {dates[-1]}). Two "
        f"timing boundaries, as in the TPU section: *chained* (the suite's "
        f"CUDA-event slope over K dependent launches, steady-state device "
        f"time a frame: what a pipelined server sees) and *program-output* "
        f"(one call with its uint8 delivery: what one cold call sees). "
        f"Refresh on the card with `python3 scripts/torch_refresh_results.py"
        f"`; re-render with `python3 scripts/torch_render_readme_results.py`"
        f". None of the TPU numbers below applies to the port.", ""]


def classical(mt: dict) -> list:
    L = ["#### Classical, 1080p → 4x (uint8 RGBA, ≤1 u8 from the float64 "
         "oracle) — `results_torch/method_throughput.json`", "",
         "| method (impl) | chained ms | GPix/s | max u8 Δ | vs reference "
         "(per output pixel) |", "| --- | --- | --- | --- | --- |"]
    for m in methods.CLASSICAL:
        r = mt[m]
        ref_gpix = REF_OUT_PX / methods.REFERENCE_MS[m] / 1e6
        L.append(f"| {m} ({r['impl']}) | {num(r['ms_per_frame'])} | "
                 f"{num(r['gpix_per_s'])} | {r['max_u8_delta']} | "
                 f"{r['gpix_per_s'] / ref_gpix:,.0f}x |")
    b = mt["bicubic"]
    L += ["", f"Bicubic per kernel: C (`pallas_mxu`) "
          f"{num(b['candidates']['pallas_mxu']['gpix_per_s'])} GPix/s, D "
          f"(`pallas_phase`) {num(b['phase_hwc_gpix_per_s'])}, D planar "
          f"{num(b['planar_gpix_per_s'])}. The reference's row is its JS "
          f"wall clock at the 0020 geometry ({methods.LR_H}x{methods.LR_W} "
          f"→ 4x), compared per output pixel.", "",
          "| rational bicubic, 1080p | impl | chained ms | GPix/s | max u8 Δ "
          "| C GPix/s | plain phase graph | plain matmul |",
          "| --- | --- | --- | --- | --- | --- | --- | --- |"]
    for s in (1.5, 2.5):
        r = mt[f"bicubic_{s}x_1080p"]
        L.append(f"| {s}x | {r['impl']} | {num(r['ms_per_frame'])} | "
                 f"{num(r['gpix_per_s'])} | {r['max_u8_delta']} | "
                 f"{num(r['pallas_mxu_gpix_per_s'])} | "
                 f"{num(r['phase_gpix_per_s'])} | "
                 f"{num(r['matmul_gpix_per_s'])} |")
    L += ["", "| downsample, /4 (`ops/downsample`) | geometry | chained ms "
          "| input MPix/s |", "| --- | --- | --- | --- |"]
    for key, r in mt.items():
        if key.startswith("downsample_"):
            L.append(f"| {key} | {r['geometry']} | {num(r['ms_per_frame'])}"
                     f" | {num(r['in_mpix_per_s'])} |")
    return L + [""]


def adaptive(mt: dict, ap: dict) -> list:
    a20, a1080 = mt["adaptive_bicubic_0020"], mt["adaptive_bicubic_1080p"]
    L = ["#### Adaptive bicubic (kernel E) — "
         "`results_torch/method_throughput.json`, "
         "`results_torch/adaptive_probe_lab.json`", "",
         f"1080p → 4x ({a1080['layout']}): {num(a1080['ms_per_frame'])} ms "
         f"chained, {num(a1080['gpix_per_s'])} GPix/s, max u8 Δ "
         f"{a1080['max_u8_delta']}. At the reference's geometry "
         f"({methods.LR_H}x{methods.LR_W} → 4x, impl {a20['impl']}, "
         f"{a20['layout']}): {num(a20['ms_per_frame'])} ms chained, "
         f"program-output {num(a20['hwc_program_output_ms'])} ms as HWC "
         f"bytes and {num(a20.get('hwc32_program_output_ms'))} ms as RGBA32 "
         f"words, max u8 Δ {a20['max_u8_delta']}: "
         f"{a20['speedup']:,.0f}x the reference's "
         f"{num(a20['reference_ms'])} ms.", "",
         f"Probe attribution ({ap['geometry']}; chained ms; full = law_alu "
         "+ luma_reads + eq_term + fma_only):", "",
         "| C | full | law_alu | luma_reads | eq_term | fma_only |",
         "| --- | --- | --- | --- | --- | --- |"]
    for c in (4, 1):
        a = ap["attribution_ms"][f"c{c}"]
        full = next(r["ms"] for r in ap["rows"].values()
                    if r["probe"] == "full"
                    and r["name"].endswith("_c1") == (c == 1))
        L.append(f"| {c} | {num(full)} | {num(a['law_alu'])} | "
                 f"{num(a['luma_reads'])} | {num(a['eq_term'])} | "
                 f"{num(a['fma_core_plus_epilogue'])} |")
    return L + [""]


def models(mt: dict) -> list:
    ref_of = {"model_1e-3-30": LEARNED_ROWS, **{
        ref: [n for n, r in methods.NEURAL if r == ref]
        for ref in {r for _, r in methods.NEURAL}}}
    row_ref = {n: ref for ref, ns in ref_of.items() for n in ns}
    L = [f"#### Learned (kernel A) and direct models (cuDNN), "
         f"{methods.LR_H}x{methods.LR_W} RGBA → 4x — "
         "`results_torch/method_throughput.json`", "",
         "| model | chained ms | program-output ms | max u8 Δ vs graph tail "
         "| reference row | vs reference |",
         "| --- | --- | --- | --- | --- | --- |"]
    for name in (*LEARNED_ROWS, *(n for n, _ in methods.NEURAL)):
        if name not in mt:
            continue
        r = mt[name]
        delta = r.get("max_u8_delta", "—")
        L.append(f"| {name} | {num(r['ms_per_frame'])} | "
                 f"{num(r['program_output_ms'])} | {delta} | "
                 f"{row_ref[name]} {num(r['reference_ms'])} ms | "
                 f"{r['speedup']:,.0f}x |")
    im, pa = mt["train_step_image_0020"], mt["train_step_patch16x48"]
    L += ["", f"WeightPredictor training steps (chained): image mode "
          f"{im['geometry']} {num(im['ms_per_step'])} ms a step, patch mode "
          f"{pa['geometry']} {num(pa['ms_per_step'])} ms.", ""]
    return L


def stages(pt: dict) -> list:
    rows, probes = pt["rows"], pt["probes"]
    L = [f"#### Learned stage table ({pt['geometry']}, "
         f"`model/{pt['checkpoint']}`) — "
         "`results_torch/packed_tail_lab.json`", "",
         "| stage | f32 chained ms | bf16 chained ms |", "| --- | --- | --- |"]
    for stage, label in (("upstream", "upstream (conv_in, conv_res, merged "
                          "map)"),
                         ("tail_graph", "tail as graph"),
                         ("tail_kernel", "tail as kernel G"),
                         ("full_graph", "full frame, graph tail"),
                         ("full_kernel", "full frame, kernel A")):
        L.append(f"| {label} | {num(rows[f'{stage}_f32']['ms'])} | "
                 f"{num(rows[f'{stage}_bf16']['ms'])} |")
    for stage in ("full_graph", "full_kernel"):
        L.append(f"| {stage.replace('_', ' ')}, program-output | "
                 f"{num(rows[f'{stage}_f32']['program_output_ms'])} | "
                 f"{num(rows[f'{stage}_bf16']['program_output_ms'])} |")
    for probe in ("matmul", "tanh", "apply"):
        L.append(f"| G probe `{probe}` | "
                 f"{num(probes[f'packed_tail_probe_{probe}_f32']['ms'])} | "
                 f"{num(probes[f'packed_tail_probe_{probe}_bf16']['ms'])} |")
    L.append(f"| G full | {num(probes['packed_tail_f32']['ms'])} | "
             f"{num(probes['packed_tail_bf16']['ms'])} |")
    return L + [""]


def sweep(bc: dict) -> list:
    L = ["#### Serving-shape sweep (bicubic, BASELINE configs) — "
         "`results_torch/bench_configs.json`", "",
         "| config | impl | chained ms | GPix/s | fps |",
         "| --- | --- | --- | --- | --- |"]
    for key, r in bc["configs"].items():
        ms = (f"{num(r['ms_per_frame'])} a frame" if "ms_per_frame" in r
              else f"{num(r['ms_per_batch'])} a batch of "
              f"{r['batch'][0]}")
        L.append(f"| {key} | {r['impl']} | {ms} | {num(r['gpix_per_s'])} | "
                 f"{num(r['fps']) if 'fps' in r else ''} |")
    L += ["", "c5_1080p_2x_stream_served is host-clock time of "
          "`Upscaler.stream()` with each frame's upload and fetch.", ""]
    return L


def curves(calls: list) -> list:
    L = ["#### Latency curves, as the serving policy reads them — "
         "`results_torch/latency_curve_call{1,2,3}.json`", "",
         "Per size the median of the three calls (ms a frame), the widest "
         "spread of a served mode's passes in any call (slowest / fastest "
         "pass), and whether grouping won in each call (a grouped frame ≤ "
         f"{configs.WIN_SLACK}x a lone one, device and served):", ""]
    for name, rows_of in (("classical (kernel C, 4x)", lambda t: t["rows"]),
                          ("learned (kernels A, B; 4x)",
                           lambda t: t["learned"]["rows"])):
        tables = [rows_of(c) for c in calls]
        threshold = configs.threshold_from(tables)
        L += [f"| {name} | group | device single | device grouped | served "
              "single | served grouped | served spread | wins per call | "
              "grouped by the rule |",
              "| --- | --- | --- | --- | --- | --- | --- | --- | --- |"]
        for size in sorted(tables[0], key=configs.size_px):
            med = {k: num(statistics.median(t[size][k] for t in tables))
                   for k in ("single_ms", "batched_ms_per_frame",
                             "served_single_ms_per_frame",
                             "served_grouped_ms_per_frame")}
            spread = max(max(ps) / min(ps) for t in tables
                         for ps in (t[size]["served_single_passes_ms_per_frame"],
                                    t[size]["served_grouped_passes_ms_per_frame"]))
            wins = "".join("y" if configs.batching_wins(t[size]) else "n"
                           for t in tables)
            groups = configs.size_px(size) < threshold
            L.append(f"| {size} | {tables[0][size]['microbatch']} | "
                     f"{med['single_ms']} | {med['batched_ms_per_frame']} | "
                     f"{med['served_single_ms_per_frame']} | "
                     f"{med['served_grouped_ms_per_frame']} | "
                     f"{spread:.2f}x | {wins} | "
                     f"{'yes' if groups else 'no'} |")
        L += ["", f"The rule over the three calls gives the {name.split()[0]}"
              f" `MICROBATCH_THRESHOLD_PX` = {threshold}.", ""]
    return L


def render() -> str:
    """The subsection, markers included, from ``results_torch/``."""
    mt = load("method_throughput.json")
    bc = load("bench_configs.json")
    pt = load("packed_tail_lab.json")
    ap = load("adaptive_probe_lab.json")
    calls = [load(f"latency_curve_call{i}.json") for i in (1, 2, 3)]
    L = [BEGIN, "", "### Measured results on the card", ""]
    L += header([mt, bc, pt, ap, *calls])
    L += classical(mt) + adaptive(mt, ap) + models(mt) + stages(pt)
    L += sweep(bc) + curves(calls)
    L += ["No quality table: the TPU section's `results/metrics_report.csv` "
          "scores the DIV2K HR images, which the repository does not hold; "
          "the card's waits for them.", "", END]
    return "\n".join(L) + "\n"


def main(argv=None) -> int:
    pa = argparse.ArgumentParser()
    pa.add_argument("--check", action="store_true",
                    help="exit 1 if README differs from the rendering")
    args = pa.parse_args(argv)
    readme = ROOT / "README.md"
    text = readme.read_text()
    if BEGIN not in text or END not in text:
        print("README.md is missing the card results markers",
              file=sys.stderr)
        return 1
    head, rest = text.split(BEGIN, 1)
    _, tail = rest.split(END, 1)
    new = head + render() + "\n" + tail.lstrip("\n")
    if args.check:
        if new != text:
            print("README.md 'Measured results on the card' is out of sync "
                  "with results_torch/: run python3 "
                  "scripts/torch_render_readme_results.py", file=sys.stderr)
            return 1
        print("README card results subsection is in sync with results_torch/")
        return 0
    readme.write_text(new)
    print("README card results subsection rewritten from results_torch/")
    return 0


if __name__ == "__main__":
    sys.exit(main())
