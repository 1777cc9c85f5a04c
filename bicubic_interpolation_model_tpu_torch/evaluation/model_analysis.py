"""Model validation and GT-vs-predicted weight analysis (counterpart of
``bicubic_interpolation_model_tpu/evaluation/model_analysis.py``, whose
checkpoint loader is ``models.zoo.load_model`` here): ``validate_model``
checks weight sums ≈ 1, extremes and negative-weight counts (the
reference's ``npm run vm``);
``compare_model`` writes global and per-channel MSE between predicted and
ground-truth weight maps, a %-difference table and histograms (``npm run
cpm``). NumPy on the host apart from the model's forward, which runs on
``device``.
"""

from __future__ import annotations

import json
import pathlib

import numpy as np
import torch

from ..data import binfmt
from ..models.zoo import load_model
from ..ops.learned import apply_weights
from ..runtime.device import conv_precision
from ..utils import imageio
from .metrics import compare_images


@torch.no_grad()
def predict_weight_map(model_dir, x, offsets, *, device="cuda") -> np.ndarray:
    """A WeightPredictor checkpoint's [H*S, W*S, 16] weights for one LR
    sample ``x`` [H, W, 4] (0..1) and its offsets [H*S, W*S, 2], as numpy."""
    model, _ = load_model(model_dir, device=device)
    dev = next(model.parameters()).device
    img = torch.as_tensor(np.asarray(x, np.float32), device=dev)[None]
    off = torch.as_tensor(np.asarray(offsets, np.float32), device=dev)[None]
    with conv_precision(torch.float32):
        return model(img, off)[0].cpu().numpy()


def validate_model(model_dir, data_root, sample_id: str | None = None,
                   hr_dir=None, log=print, *, device="cuda") -> bool:
    """Predict on one sample; check weight sums ≈ 1, report extremes and
    negative-weight counts. With ``hr_dir`` also rebuild the image and
    report PSNR/SSIM vs the HR ground truth."""
    data_root = pathlib.Path(data_root)
    meta = binfmt.read_metadata(data_root / "metadata.json")
    sid = sample_id or sorted(meta)[0]
    x = binfmt.read_tensor(data_root / "X" / f"{sid}.bin")
    off = binfmt.read_tensor(data_root / "offset" / f"{sid}.bin")
    pred = predict_weight_map(model_dir, x, off, device=device)

    sums = pred.sum(-1)
    neg_frac = float((pred < 0).mean())
    log(f"[{sid}] pred weights: shape {pred.shape}, "
        f"sum mean={sums.mean():.4f} min={sums.min():.4f} max={sums.max():.4f}, "
        f"negative fraction={neg_frac:.3f}")
    h, w = pred.shape[:2]
    for (py, px, tag) in [(h // 2, w // 2, "center"), (0, 0, "corner")]:
        ws = pred[py, px]
        log(f"  pixel {tag} ({py},{px}): sum={ws.sum():.4f} "
            f"min={ws.min():.4f} max={ws.max():.4f} "
            f"negatives={int((ws < 0).sum())}")
    ok = bool(abs(float(sums.mean()) - 1.0) < 0.1)

    if hr_dir is not None:
        hr_path = pathlib.Path(hr_dir) / f"{sid}.png"
        if hr_path.exists():
            sr = apply_weights(x * 255.0, torch.from_numpy(pred)).numpy()
            sr = sr.astype(np.uint8)
            hr = imageio.load_rgba(hr_path)[:sr.shape[0], :sr.shape[1]]
            m = compare_images(hr, sr)
            log(f"  rebuild vs HR: PSNR={m.psnr:.2f} dB SSIM={m.ssim:.4f} "
                f"MSE={m.mse:.2f}")
        else:
            log(f"  (no HR image for {sid} under {hr_dir}; rebuild skipped)")
    log("OK" if ok else "FAIL: mean weight sum far from 1")
    return ok


def compare_model(model_dir, data_root, out_dir, *, max_samples: int = 4,
                  log=print, device="cuda") -> dict:
    """Predicted-vs-GT weight statistics + per-channel table + histograms.
    Writes comparison.txt, stats.json and a 16-panel histogram PNG."""
    data_root = pathlib.Path(data_root)
    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    meta = binfmt.read_metadata(data_root / "metadata.json")
    ids = sorted(meta)[:max_samples]

    gt_all, pred_all = [], []
    for sid in ids:
        x = binfmt.read_tensor(data_root / "X" / f"{sid}.bin")
        off = binfmt.read_tensor(data_root / "offset" / f"{sid}.bin")
        y = binfmt.read_tensor(data_root / "Y" / f"{sid}.bin")
        pred = predict_weight_map(model_dir, x, off, device=device)
        gt_all.append(y.reshape(-1, 16))
        pred_all.append(pred.reshape(-1, 16))
        log(f"analyzed {sid}")
    gt = np.concatenate(gt_all)
    pred = np.concatenate(pred_all)

    err = pred - gt
    per_ch_mse = (err * err).mean(axis=0)
    per_ch_mean_gt = gt.mean(axis=0)
    per_ch_mean_pred = pred.mean(axis=0)
    with np.errstate(divide="ignore", invalid="ignore"):
        pct = 100.0 * np.abs(per_ch_mean_pred - per_ch_mean_gt) / np.abs(per_ch_mean_gt)

    lines = [
        f"samples: {ids}",
        f"global MSE: {(err * err).mean():.8f}",
        f"global MAE: {np.abs(err).mean():.8f}",
        "",
        "channel |   GT mean |  pred mean |     MSE    |  %diff",
        "--------+-----------+------------+------------+--------",
    ]
    for i in range(16):
        lines.append(f"   w{i:02d}  | {per_ch_mean_gt[i]:9.5f} | "
                     f"{per_ch_mean_pred[i]:10.5f} | {per_ch_mse[i]:10.7f} | "
                     f"{pct[i]:6.2f}%")
    (out_dir / "comparison.txt").write_text("\n".join(lines) + "\n")

    stats = {
        "samples": ids,
        "global_mse": float((err * err).mean()),
        "global_mae": float(np.abs(err).mean()),
        "per_channel_mse": per_ch_mse.tolist(),
        "per_channel_pct_diff": [None if not np.isfinite(p) else float(p)
                                 for p in pct],
    }
    (out_dir / "stats.json").write_text(json.dumps(stats, indent=2))
    _write_histograms(gt, pred, out_dir / "weight_histograms.png")
    log(f"analysis → {out_dir}")
    return stats


def _write_histograms(gt, pred, path, bins: int = 64):
    """GT vs predicted weight histograms, one panel per channel, rendered as
    a PNG without any plotting dependency (direct raster)."""
    panel_w, panel_h, gap = 256, 128, 8
    cols, rows = 4, 4
    img = np.full(((panel_h + gap) * rows + gap,
                   (panel_w + gap) * cols + gap, 4), 255, np.uint8)
    lo, hi = -0.8, 1.2
    for ch in range(16):
        r, c = divmod(ch, 4)
        y0 = gap + r * (panel_h + gap)
        x0 = gap + c * (panel_w + gap)
        hg, _ = np.histogram(np.clip(gt[:, ch], lo, hi), bins=bins, range=(lo, hi))
        hp, _ = np.histogram(np.clip(pred[:, ch], lo, hi), bins=bins, range=(lo, hi))
        top = max(hg.max(), hp.max(), 1)
        bw = panel_w // bins
        for b in range(bins):
            for hist, color in ((hg, (60, 120, 216)), (hp, (220, 80, 60))):
                h = int(panel_h * hist[b] / top)
                if h:
                    ys = slice(y0 + panel_h - h, y0 + panel_h)
                    xs = slice(x0 + b * bw, x0 + (b + 1) * bw)
                    region = img[ys, xs, :3]
                    img[ys, xs, :3] = (region // 2 + np.array(color, np.uint8) // 2)
        img[y0 + panel_h - 1, x0:x0 + panel_w, :3] = 0
    imageio.save_png(path, img)
