"""In-memory training data without materialising offset/Y tensors
(counterpart of ``bicubic_interpolation_model_tpu/data/onthefly.py``).

With the training convention (data_generator.js:125-134) the subpixel
offsets, and therefore the GT weight maps, are functions of (x mod S,
y mod S) only: S x S tiles repeated over the image. This loader keeps only
the LR images in memory and the trainer synthesises the target tiles per
patch, equal to what the stored dataset holds for scale-aligned crops.
"""

from __future__ import annotations

import pathlib

import numpy as np

from ..ops.downsample import downsample_np
from ..ops.learned import gt_weight_map, offset_map
from ..utils import imageio
from .div2k import IMAGE_EXTS, align_crop


def load_hr_dir(hr_dir, *, scale: int = 4, down_method: str = "cubic",
                limit: int | None = None, keep_hr: bool = False,
                log=print) -> dict[str, dict]:
    """HR image dir → {id: {"X": LR float32 HWC/255 [, "HR": uint8]}}."""
    hr_dir = pathlib.Path(hr_dir)
    files = sorted(p for p in hr_dir.iterdir() if p.suffix.lower() in IMAGE_EXTS)
    if limit is not None:
        files = files[:limit]
    out = {}
    for p in files:
        try:
            hr = align_crop(imageio.load_rgba(p), scale)
            lr = downsample_np(hr, float(scale), down_method)
            rec = {"X": lr.astype(np.float32) / 255.0}
            if keep_hr:
                rec["HR"] = hr
            out[p.stem] = rec
        except Exception as e:
            log(f"skip {p.name}: {e}")
    return out


def target_tiles(patch_lr: int, scale: int, a: float = -0.5, *,
                 device="cuda"):
    """(offset, Y) maps for a scale-aligned patch of patch_lr LR pixels,
    identical to any aligned crop of the full-image maps: float32 tensors
    on ``device``."""
    n = patch_lr * scale
    off = offset_map(n, n, float(scale), "train", device=device)
    y = gt_weight_map(n, n, float(scale), "train", a, device=device)
    return off, y
