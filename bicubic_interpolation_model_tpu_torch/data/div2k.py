"""DIV2K training/test data generation (counterpart of
``bicubic_interpolation_model_tpu/data/div2k.py``).

The reference's generation flow (data_generator.js:202-272 /
testData_generator.js) per HR image:

  1. load, ensure alpha, crop to a multiple of the scale  (:44-60)
  2. antialiased downsample HR→LR (cubic)                 (:62-88)
  3. per-HR-pixel subpixel offsets [H_sr,W_sr,2]          (:125-134)
  4. per-HR-pixel 16 GT Keys weights [H_sr,W_sr,16]       (:136-179)
  5. save X (LR/255), offset, Y as header-prefixed .bin + metadata.json

Step 2 is the host's float64 :func:`..ops.downsample.downsample_np`, as in
the JAX module, so ``X`` is the same bytes; steps 3-4 are torch on
``device`` (the card unless the caller passes ``device="cpu"``). The v4.0
"adaptive" variant (version4.0/utils/data_generator.js:196-244) modulates
the GT weights by local luma contrast before normalisation.
"""

from __future__ import annotations

import dataclasses
import pathlib

import numpy as np
import torch

from ..ops.adaptive import adaptive_gt_factors
from ..ops.downsample import downsample_np
from ..ops.learned import cubic_keys_jnp, gt_weight_map, offset_map
from ..runtime.device import resolve_device
from ..utils import imageio
from . import binfmt

IMAGE_EXTS = {".png", ".jpg", ".jpeg"}


@dataclasses.dataclass
class SampleRecord:
    sample_id: str
    h_lr: int
    w_lr: int
    h_sr: int
    w_sr: int


def align_crop(img: np.ndarray, factor: int) -> np.ndarray:
    """Crop to the top-left region whose sides are multiples of ``factor``."""
    h = (img.shape[0] // factor) * factor
    w = (img.shape[1] // factor) * factor
    return img[:h, :w]


def generate_sample(hr_rgba: np.ndarray, scale: int = 4,
                    down_method: str = "cubic", adaptive: bool = False, *,
                    device="cuda"):
    """HR uint8 RGBA → numpy (X [H_lr,W_lr,4] f32/255, offsets
    [H_sr,W_sr,2], weights [H_sr,W_sr,16]); the maps are computed on
    ``device``."""
    dev = resolve_device(device)
    hr = align_crop(hr_rgba, scale)
    h_sr, w_sr = hr.shape[:2]
    lr_u8 = downsample_np(hr, float(scale), down_method)
    x = np.asarray(lr_u8, dtype=np.float32) / 255.0
    offsets = offset_map(h_sr, w_sr, float(scale), "train", device=dev)
    if adaptive:
        weights = _adaptive_weights(x, h_sr, w_sr, scale, device=dev)
    else:
        weights = gt_weight_map(h_sr, w_sr, float(scale), "train",
                                device=dev)
    return x, offsets.cpu().numpy(), weights.cpu().numpy()


def _adaptive_weights(lr_float, h_sr, w_sr, scale, a=-0.5, *,
                      device="cuda"):
    """GT weights modulated by per-tap luma-contrast factors before
    normalisation (v4.0 data_generator.js:128-151), on ``device``."""
    dev = resolve_device(device)
    off = offset_map(h_sr, w_sr, float(scale), "train", device=dev)
    dx, dy = off[..., 0], off[..., 1]

    def taps(d):
        return torch.stack([cubic_keys_jnp(1.0 + d, a), cubic_keys_jnp(d, a),
                            cubic_keys_jnp(1.0 - d, a),
                            cubic_keys_jnp(2.0 - d, a)], dim=-1)

    grid = taps(dy)[..., :, None] * taps(dx)[..., None, :]
    base = grid.reshape(grid.shape[:-2] + (16,))  # unnormalised, like v4.0
    w = base * adaptive_gt_factors(lr_float, scale, device=dev)
    s = w.sum(dim=-1, keepdim=True)
    return torch.where(s > 0, w / s, torch.zeros_like(w))


def process_images(hr_dir, out_root, *, scale: int = 4, split: str = "train",
                   down_method: str = "cubic", adaptive: bool = False,
                   limit: int | None = None, log=print,
                   device="cuda") -> list[SampleRecord]:
    """Generate the dataset for every image in ``hr_dir``; per-image failures
    are isolated (logged, loop continues), matching data_generator.js:268-270.
    A missing card is no per-image failure: it raises before the loop."""
    dev = resolve_device(device)
    hr_dir = pathlib.Path(hr_dir)
    root = pathlib.Path(out_root) / split
    dirs = {k: root / k for k in ("X", "offset", "Y")}
    for d in dirs.values():
        d.mkdir(parents=True, exist_ok=True)
    meta_path = root / "metadata.json"

    records = []
    files = sorted(p for p in hr_dir.iterdir()
                   if p.suffix.lower() in IMAGE_EXTS)
    if limit is not None:
        files = files[:limit]
    for p in files:
        try:
            log(f"Processing: {p.name}")
            hr = imageio.load_rgba(p)
            x, offsets, weights = generate_sample(
                hr, scale, down_method, adaptive, device=dev)
            sid = p.stem
            h_lr, w_lr = x.shape[:2]
            h_sr, w_sr = offsets.shape[:2]
            binfmt.update_metadata(meta_path, sid, h_lr, w_lr, h_sr, w_sr,
                                   variant="adaptive" if adaptive else None)
            binfmt.write_tensor(dirs["X"] / f"{sid}.bin", x)
            binfmt.write_tensor(dirs["offset"] / f"{sid}.bin", offsets)
            binfmt.write_tensor(dirs["Y"] / f"{sid}.bin", weights)
            records.append(SampleRecord(sid, h_lr, w_lr, h_sr, w_sr))
        except Exception as e:
            log(f"Error processing {p.name}: {e}")
    return records
