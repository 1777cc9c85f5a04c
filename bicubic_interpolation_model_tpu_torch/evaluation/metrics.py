"""Quality metrics with the reference's exact semantics (counterpart of
``bicubic_interpolation_model_tpu/evaluation/metrics.py``; NumPy float64,
bit-equal to it):

- grayscale:  BT.601 u8 round  g = round(0.299 r + 0.587 g + 0.114 b)
- MSE:        mean squared error over gray pixels
- PSNR:       10*log10(255^2 / MSE), +inf when MSE == 0
- SSIM:       Wang et al. 2004 (gaussian 11x11, K1=.01, K2=.03) after the
              customary pre-downsampling by f = max(1, round(min(h, w)/256))

The reference's published SSIM column is an artifact of handing ssim.js a
gray buffer where it expects RGBA; PSNR/MSE match the reference CSV exactly,
SSIM in ordering only.
"""

from __future__ import annotations

import dataclasses
import numpy as np


def to_gray_bt601(img_u8: np.ndarray) -> np.ndarray:
    """HWC uint8 (>=3 channels) → HW uint8 gray, JS rounding."""
    a = img_u8.astype(np.float64)
    g = 0.299 * a[..., 0] + 0.587 * a[..., 1] + 0.114 * a[..., 2]
    return np.floor(g + 0.5).astype(np.uint8)


def mse(a_gray: np.ndarray, b_gray: np.ndarray) -> float:
    d = a_gray.astype(np.float64) - b_gray.astype(np.float64)
    return float(np.mean(d * d))


def psnr(mse_value: float, max_value: float = 255.0) -> float:
    if mse_value == 0:
        return float("inf")
    return float(10.0 * np.log10(max_value * max_value / mse_value))


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return g / g.sum()


def _correlate_axis(a: np.ndarray, kernel: np.ndarray, axis: int) -> np.ndarray:
    """'valid' 1-D correlation along ``axis`` (vectorized shifted-slice sum)."""
    k = len(kernel)
    n = a.shape[axis] - k + 1
    out = None
    for i, g in enumerate(kernel):
        sl = [slice(None)] * a.ndim
        sl[axis] = slice(i, i + n)
        term = g * a[tuple(sl)]
        out = term if out is None else out + term
    return out


def _filter2(a: np.ndarray, window: np.ndarray) -> np.ndarray:
    return _correlate_axis(_correlate_axis(a, window, 0), window, 1)


def _box_downsample(a: np.ndarray, f: int) -> np.ndarray:
    h, w = (a.shape[0] // f) * f, (a.shape[1] // f) * f
    return a[:h, :w].reshape(h // f, f, w // f, f).mean(axis=(1, 3))


def ssim(a_gray: np.ndarray, b_gray: np.ndarray, *, window_size: int = 11,
         sigma: float = 1.5, k1: float = 0.01, k2: float = 0.03,
         max_value: float = 255.0, downsample: bool = True) -> float:
    """Mean SSIM (Wang et al. 2004) on uint8 gray images."""
    x = a_gray.astype(np.float64)
    y = b_gray.astype(np.float64)
    if downsample:
        f = int(max(1, round(min(x.shape[:2]) / 256.0)))
        if f > 1:
            x = _box_downsample(x, f)
            y = _box_downsample(y, f)
    w = _gaussian_window(window_size, sigma)
    c1 = (k1 * max_value) ** 2
    c2 = (k2 * max_value) ** 2
    mu_x = _filter2(x, w)
    mu_y = _filter2(y, w)
    mu_xx = mu_x * mu_x
    mu_yy = mu_y * mu_y
    mu_xy = mu_x * mu_y
    sigma_xx = _filter2(x * x, w) - mu_xx
    sigma_yy = _filter2(y * y, w) - mu_yy
    sigma_xy = _filter2(x * y, w) - mu_xy
    s = ((2 * mu_xy + c1) * (2 * sigma_xy + c2)) / (
        (mu_xx + mu_yy + c1) * (sigma_xx + sigma_yy + c2))
    return float(s.mean())


@dataclasses.dataclass
class Metrics:
    psnr: float
    ssim: float
    mse: float


def compare_images(img1_u8: np.ndarray, img2_u8: np.ndarray, *,
                   ssim_downsample: bool = True) -> Metrics:
    """Full metric set on two same-size HWC uint8 images."""
    if img1_u8.shape[:2] != img2_u8.shape[:2]:
        raise ValueError(
            f"image size mismatch: {img1_u8.shape} vs {img2_u8.shape}")
    g1 = to_gray_bt601(img1_u8)
    g2 = to_gray_bt601(img2_u8)
    m = mse(g1, g2)
    return Metrics(psnr=psnr(m), ssim=ssim(g1, g2, downsample=ssim_downsample),
                   mse=m)
