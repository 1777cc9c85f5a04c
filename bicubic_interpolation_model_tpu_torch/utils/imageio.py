"""Host-side image IO (counterpart of
``bicubic_interpolation_model_tpu/utils/imageio.py``): decode/encode PNG
and JPEG, raw RGBA buffers. Prefers the native C++ codec
(``runtime/native``) when it builds; falls back to PIL. Loads return HWC
uint8 RGBA.
"""

from __future__ import annotations

import pathlib

import numpy as np


def _native():
    try:
        from ..runtime import native
        return native if native.available() else None
    except Exception:
        return None


def load_rgba(path) -> np.ndarray:
    """Decode an image file to HWC uint8 RGBA."""
    n = _native()
    lower = str(path).lower()
    if n is not None and lower.endswith(".png"):
        arr = n.decode_png(path)
        if arr is not None:
            return arr
    if n is not None and lower.endswith((".jpg", ".jpeg")):
        arr = n.decode_jpeg(path)   # None for progressive → PIL below
        if arr is not None:
            return arr
    from PIL import Image
    with Image.open(path) as im:
        return np.asarray(im.convert("RGBA"))


def load_rgb(path) -> np.ndarray:
    from PIL import Image
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def save_png(path, img: np.ndarray) -> None:
    """Encode HWC uint8 (RGB/RGBA/gray) to PNG — or to JPEG when the path
    says so (``.jpg``/``.jpeg``), mirroring sharp's write-by-extension."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    img = np.ascontiguousarray(img)
    if str(path).lower().endswith((".jpg", ".jpeg")):
        save_jpeg(path, img)
        return
    n = _native()
    if n is not None and img.ndim == 3 and img.shape[2] == 4:
        if n.encode_png(path, img):
            return
    from PIL import Image
    if img.ndim == 2:
        mode = "L"
    else:
        mode = {1: "L", 3: "RGB", 4: "RGBA"}[img.shape[2]]
        if img.shape[2] == 1:
            img = img[..., 0]
    Image.fromarray(img, mode=mode).save(path)


save_image = save_png  # dispatches on extension; alias for readability


def save_jpeg(path, img: np.ndarray, quality: int = 92) -> None:
    """Encode HWC uint8 (RGB/RGBA/gray) to baseline 4:4:4 JPEG via the
    from-scratch native encoder (csrc/bimjpeg.cpp); PIL fallback."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    img = np.ascontiguousarray(img)
    n = _native()
    if n is not None:
        gray = img.ndim == 2 or img.shape[2] == 1
        if gray:
            g = img if img.ndim == 2 else img[..., 0]
            rgba = np.repeat(g[..., None], 4, axis=-1)
        elif img.shape[2] == 3:
            rgba = np.concatenate(
                [img, np.full(img.shape[:2] + (1,), 255, np.uint8)], -1)
        else:
            rgba = img
        if n.encode_jpeg(path, np.ascontiguousarray(rgba), quality,
                         gray=gray):
            return
    from PIL import Image
    arr = img[..., 0] if (img.ndim == 3 and img.shape[2] == 1) else img
    mode = "L" if arr.ndim == 2 else {3: "RGB", 4: "RGBA"}[arr.shape[2]]
    im = Image.fromarray(arr, mode=mode)
    if mode == "RGBA":
        im = im.convert("RGB")  # JPEG has no alpha
    im.save(path, quality=quality, subsampling=0)
