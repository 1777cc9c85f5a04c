"""Dataset validation (counterpart of
``bicubic_interpolation_model_tpu/data/validate.py``, NumPy only: the same
checks as the reference's standalone validators,
version3.0/utils/validate_data.js ``npm run vd`` and v2.0's streaming
whole-dataset scan, version2.0/utils/validate_data.js:104-208).

Checks per sample (vectorized over every pixel, not 5 random ones):
shapes vs metadata.json, NaN/Inf counts, offset range [-0.5, 0.5), weight
range [-0.75, 2.0], and 16-weight sums within 0.01 of 1 (or exactly 0 for
degenerate pixels).
"""

from __future__ import annotations

import dataclasses
import pathlib

import numpy as np

from . import binfmt


@dataclasses.dataclass
class ValidationReport:
    sample_id: str
    ok: bool
    errors: list[str]

    def __bool__(self):
        return self.ok


def validate_sample(root, sample_id: str, *, tol: float = 0.01) -> ValidationReport:
    root = pathlib.Path(root)
    meta = binfmt.read_metadata(root / "metadata.json")
    errors: list[str] = []
    if sample_id not in meta:
        return ValidationReport(sample_id, False, ["missing from metadata"])
    m = meta[sample_id]

    def load(kind):
        return binfmt.read_tensor(root / kind / f"{sample_id}.bin")

    try:
        x = load("X")
        off = load("offset")
        y = load("Y")
    except Exception as e:
        return ValidationReport(sample_id, False, [f"load failed: {e}"])

    expect = {
        "X": (m["H_lr"], m["W_lr"], m["channels"]["X"]),
        "offset": (m["H_sr"], m["W_sr"], m["channels"]["offset"]),
        "Y": (m["H_sr"], m["W_sr"], m["channels"]["Y"]),
    }
    for name, arr in (("X", x), ("offset", off), ("Y", y)):
        if arr.shape != expect[name]:
            errors.append(f"{name} shape {arr.shape} != metadata {expect[name]}")
        bad = np.count_nonzero(~np.isfinite(arr))
        if bad:
            errors.append(f"{name} has {bad} NaN/Inf values")

    if not errors:
        if x.min() < 0 or x.max() > 1:
            errors.append(f"X out of [0,1]: [{x.min()}, {x.max()}]")
        if off.min() < -0.5 or off.max() >= 0.5:
            errors.append(f"offsets out of [-0.5,0.5): [{off.min()}, {off.max()}]")
        if y.min() < -0.75 or y.max() > 2.0:
            errors.append(f"weights out of [-0.75,2.0]: [{y.min()}, {y.max()}]")
        sums = y.sum(axis=-1)
        bad = np.abs(sums - 1.0) > tol
        bad &= sums != 0.0  # degenerate pixels are stored as all-zero
        if bad.any():
            errors.append(
                f"{int(bad.sum())} pixels with weight sum != 1±{tol} "
                f"(worst {sums[np.unravel_index(np.abs(sums - 1).argmax(), sums.shape)]:.4f})"
            )
    return ValidationReport(sample_id, not errors, errors)


def validate_dataset(root, *, log=print) -> list[ValidationReport]:
    root = pathlib.Path(root)
    meta = binfmt.read_metadata(root / "metadata.json")
    reports = []
    for sid in sorted(meta):
        rep = validate_sample(root, sid)
        status = "OK" if rep.ok else "FAIL: " + "; ".join(rep.errors)
        log(f"[{sid}] {status}")
        reports.append(rep)
    return reports
