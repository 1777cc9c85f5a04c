#!/usr/bin/env python3
"""Bench of the PyTorch/CUDA port: prints ONE JSON line with the headline
metric, with ``bench.py``'s keys and ``"backend": "cuda"``.

    python3 bench_torch.py

Headline: bicubic 4x upscale of a 1080p RGBA frame (output 7680x4320x4,
~33.2 MPix) on one card, best of kernel C (``pallas_mxu``), kernel D
(``pallas_phase``) and kernel D's planar layout (``pallas_phase_planar``)
that keep ±1-u8-LSB parity with the port's float64 JS-semantics oracle
over the full output geometry (every 67th row). Device time per frame from
CUDA events (``bicubic_interpolation_model_tpu_torch/bench/suite.py``).

vs_baseline is the speedup over the reference's JS bicubic kernel
(0.39 MPix/s, BASELINE.md / cp_performance/bsr).

Each impl's row goes to stderr as ``# {...}`` with the card's name and
power limit, its device-only time and its time per served frame (the host
frame uploaded, resized and fetched into pinned memory); one more row holds
each impl's plan-building cost. Exits 1 with an error line without a card,
when an impl raises, or when any impl reads more than 1 u8 from the oracle.
"""

import json
import sys

IMPLS = ("pallas_mxu", "pallas_phase", "pallas_phase_planar")


def last_line(best: dict, results: list[dict], backend: str = "cuda") -> dict:
    """``bench.py``'s JSON line for ``suite.headline``'s result."""
    from bicubic_interpolation_model_tpu_torch.bench.suite import (
        REFERENCE_BICUBIC_GPIX_S)
    value = round(best["gpix_per_s"], 3)
    hwc = next((r for r in results
                if r.get("impl") == "pallas_phase" and "gpix_per_s" in r),
               None)
    mxu = next((r for r in results
                if r.get("impl") == "pallas_mxu" and "gpix_per_s" in r
                and r.get("max_u8_delta", 9) <= 1), None)
    out = {
        "metric": "bicubic_4x_throughput",
        "value": value,
        "unit": "GPix/s",
        "vs_baseline": round(value / REFERENCE_BICUBIC_GPIX_S, 1),
        "impl": best["impl"],
        "max_u8_delta": best["max_u8_delta"],
        "parity_geometry": best.get("parity_geometry"),
        "backend": backend,
    }
    if best.get("layout"):
        out["layout"] = best["layout"]
    if mxu is not None and mxu is not best:
        out["delivered_hwc_gpix_per_s"] = round(mxu["gpix_per_s"], 3)
    if hwc is not None and hwc is not best:
        out["hwc_interleaved_gpix_per_s"] = round(hwc["gpix_per_s"], 3)
    return out


def failures(results: list[dict]) -> list[dict]:
    """The impls that raised or read more than 1 u8 from the oracle."""
    return [r for r in results
            if "error" in r or r.get("max_u8_delta", 9) > 1]


def _error_line(reason: str) -> str:
    return json.dumps({"metric": "bicubic_4x_throughput", "value": 0.0,
                       "unit": "GPix/s", "vs_baseline": 0.0,
                       "error": reason})


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print(_error_line("no CUDA device visible"))
        return 1
    from bicubic_interpolation_model_tpu_torch.bench.suite import headline
    from chip_smoke import card

    best, results = headline(impls=IMPLS, runs=5)
    name_power = card()
    for r in results:
        print(f"# {json.dumps(dict(r, card=name_power))}", file=sys.stderr)
    print("# " + json.dumps({"plan_build_ms": {
        r["impl"]: r["plan_build_ms"] for r in results
        if "plan_build_ms" in r}, "card": name_power}), file=sys.stderr)
    bad = failures(results)
    if bad or best is None:
        print(_error_line(f"impls failed or missed parity: {bad}"))
        return 1
    print(json.dumps(last_line(best, results)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
