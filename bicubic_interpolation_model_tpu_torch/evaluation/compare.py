"""Batch quality evaluation (counterpart of
``bicubic_interpolation_model_tpu/evaluation/compare.py``, the reference's
``npm run cpi``): per (image id, method) load the HR and the rebuilt image,
compute PSNR/SSIM/MSE, write a diff visualization, accumulate; then
per-method averages and ``metrics_report.csv`` with the reference schema
(IMAGE_ID,METHOD,PSNR(dB),SSIM,MSE + AVERAGE rows).

Diff images are the red-scale map of the R channel's absolute difference
(R=255, G=B=255*(1-|Δ|/255)), what the reference builds before it
composites the original over it.
"""

from __future__ import annotations

import dataclasses
import pathlib

import numpy as np

from ..utils import imageio
from .metrics import Metrics, compare_images


@dataclasses.dataclass
class CompareResult:
    image_id: str
    method: str
    metrics: Metrics | None
    error: str | None = None


def diff_image(img1_u8: np.ndarray, img2_u8: np.ndarray) -> np.ndarray:
    """Red-scale abs-diff of the R channel (compare_image.js:167-173)."""
    d = np.abs(img1_u8[..., 0].astype(np.float64)
               - img2_u8[..., 0].astype(np.float64)) / 255.0
    h, w = d.shape
    out = np.empty((h, w, 4), np.uint8)
    out[..., 0] = 255
    gb = np.floor(255.0 * (1.0 - d) + 0.5).astype(np.uint8)
    out[..., 1] = gb
    out[..., 2] = gb
    out[..., 3] = 255
    return out


def compare_pair(hr_path, rebuilt_path, diff_path=None) -> Metrics:
    hr = imageio.load_rgba(hr_path)
    rb = imageio.load_rgba(rebuilt_path)
    if hr.shape[:2] != rb.shape[:2]:
        raise ValueError(
            f"size mismatch: {hr_path} {hr.shape[:2]} vs {rebuilt_path} {rb.shape[:2]}")
    m = compare_images(hr, rb)
    if diff_path is not None:
        imageio.save_png(diff_path, diff_image(hr, rb))
    return m


def run_comparison(cp_image_root, image_ids, methods, *, write_diffs=True,
                   log=print) -> list[CompareResult]:
    """Evaluate every (id, method) pair under a cp_image-layout tree:
    hr_images/<id>.png vs rebuild_hr_images/<id>/<method>.png."""
    root = pathlib.Path(cp_image_root)
    results = []
    for image_id in image_ids:
        for method in methods:
            hr = root / "hr_images" / f"{image_id}.png"
            rb = root / "rebuild_hr_images" / image_id / f"{method}.png"
            diff = (root / "or_diff" / f"diff_{image_id}_{method}.png"
                    if write_diffs else None)
            try:
                m = compare_pair(hr, rb, diff)
                results.append(CompareResult(image_id, method, m))
                log(f"[{image_id}/{method}] PSNR={m.psnr:.2f}dB "
                    f"SSIM={m.ssim:.4f} MSE={m.mse:.2f}")
            except Exception as e:
                results.append(CompareResult(image_id, method, None, str(e)))
                log(f"[{image_id}/{method}] ERROR: {e}")
    return results


def method_averages(results: list[CompareResult]) -> dict[str, Metrics]:
    """Per-method averages; +inf PSNR counts as 100 dB like the reference
    (compare_image.js:266-269)."""
    out: dict[str, Metrics] = {}
    methods = {r.method for r in results if r.metrics}
    for m in sorted(methods):
        rs = [r.metrics for r in results if r.method == m and r.metrics]
        psnrs = [100.0 if np.isinf(x.psnr) else x.psnr for x in rs]
        out[m] = Metrics(
            psnr=float(np.mean(psnrs)),
            ssim=float(np.mean([x.ssim for x in rs])),
            mse=float(np.mean([x.mse for x in rs])),
        )
    return out


def export_csv(path, results: list[CompareResult],
               averages: dict[str, Metrics]) -> None:
    """metrics_report.csv with the reference schema + AVERAGE rows."""
    lines = ["IMAGE_ID,METHOD,PSNR(dB),SSIM,MSE"]
    for r in results:
        if r.metrics is None:
            continue
        lines.append(f"{r.image_id},{r.method},{r.metrics.psnr},"
                     f"{r.metrics.ssim},{r.metrics.mse}")
    for method, m in averages.items():
        lines.append(f"AVERAGE,{method},{m.psnr:.2f},{m.ssim:.4f},{m.mse:.2f}")
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text("\n".join(lines) + "\n")
