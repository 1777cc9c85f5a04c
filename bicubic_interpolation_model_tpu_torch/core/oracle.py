"""NumPy float64 oracle reproducing the reference's JS semantics bit-for-bit.

The checked-in "golden" rebuild PNGs in the reference are 256-color palette
images (lossy), so parity testing is gated against this oracle instead: it
replicates the JS per-pixel math in float64 (JS numbers) including

  * corner-aligned mapping ox = x/scale,
  * taps clamped to the image with weights evaluated at the clamped position,
  * normalization by the actual 2-D weight sum,
  * JS ``Math.round`` (half away from zero for positives: floor(v+0.5)) and
    Uint8ClampedArray clamping to [0, 255].

Sources: reference version3.0/utils/{bicubic,bilinear,nearestNeighbor,lanczos,
adaptive_bicubic}_super_resolution.js.

This module is test/reference infrastructure — device code lives in ``ops``.
The port's own copy of ``bicubic_interpolation_model_tpu/core/oracle.py``
(the port imports nothing of the JAX package), on the port's
``core/{kernels,plan}.py``; ``tests/test_torch_oracle.py`` holds the two
byte-equal.
"""

from __future__ import annotations

import numpy as np

from .kernels import cubic_keys
from .plan import AxisPlan, plan_axis, out_size


def js_round_u8(v: np.ndarray) -> np.ndarray:
    """JS ``Math.round`` then Uint8ClampedArray store: clip(floor(v+0.5), 0, 255)."""
    return np.clip(np.floor(v + 0.5), 0, 255).astype(np.uint8)


def _apply_plan(img: np.ndarray, plan: AxisPlan, axis: int) -> np.ndarray:
    """out[i] = sum_k w[i,k] * img[idx[i,k]] along ``axis`` in float64."""
    g = np.take(img, plan.idx.reshape(-1), axis=axis)
    shape = list(g.shape)
    shape[axis:axis + 1] = [plan.n_out, plan.taps]
    g = g.reshape(shape)
    w = plan.w.astype(np.float64)
    wshape = [1] * g.ndim
    wshape[axis] = plan.n_out
    wshape[axis + 1] = plan.taps
    return (g * w.reshape(wshape)).sum(axis=axis + 1)


def resize_oracle(img_u8: np.ndarray, scale: float, method: str = "bicubic",
                  **kw) -> np.ndarray:
    """Resize an HWC uint8 image with exact JS semantics. Returns uint8 HWC.

    Separable two-pass float64 evaluation of the same math as the JS double
    loop; per-axis normalization is algebraically identical to the JS 2-D
    normalization (sum(wx*wy) = sum(wx)*sum(wy)).
    """
    assert img_u8.ndim == 3, "expected HWC"
    h, w = img_u8.shape[:2]
    plan_y = plan_axis(method, h, scale, **kw)
    plan_x = plan_axis(method, w, scale, **kw)
    x = img_u8.astype(np.float64)
    x = _apply_plan(x, plan_y, axis=0)
    x = _apply_plan(x, plan_x, axis=1)
    return js_round_u8(x)


def resize_oracle_rows(img_u8: np.ndarray, scale: float, rows: np.ndarray,
                       method: str = "bicubic", **kw) -> np.ndarray:
    """Exact oracle evaluated only at the given OUTPUT rows.

    Separability makes this exact and cheap: the row pass is computed only
    for the taps of the requested rows, then the full column pass runs on
    those few rows. At 1080p→4x the full oracle materializes multi-GB f64
    intermediates (~9 min); this takes well under a second for ~64 rows —
    what the full-geometry hardware parity gate (bench.suite.check_parity)
    uses.
    """
    assert img_u8.ndim == 3, "expected HWC"
    h, w = img_u8.shape[:2]
    plan_y = plan_axis(method, h, scale, **kw)
    plan_x = plan_axis(method, w, scale, **kw)
    rows = np.asarray(rows)
    x = img_u8.astype(np.float64)
    g = x[plan_y.idx[rows]]                       # [n_rows, taps, W, C]
    wy = plan_y.w.astype(np.float64)[rows][..., None, None]
    x = (g * wy).sum(axis=1)                      # [n_rows, W, C]
    x = _apply_plan(x, plan_x, axis=1)
    return js_round_u8(x)


def resize_oracle_loops(img_u8: np.ndarray, scale: float, a: float = -0.5) -> np.ndarray:
    """Literal (slow) transcription of the JS bicubic double loop, float64.

    Used once in tests to certify that the separable oracle above matches the
    non-separable-looking original loop (bicubic_super_resolution.js:35-80).
    Only run on tiny images.
    """
    h, w, c = img_u8.shape
    nw = out_size(w, scale)
    nh = out_size(h, scale)
    data = img_u8.astype(np.float64)
    out = np.zeros((nh, nw, c), dtype=np.uint8)
    for y in range(nh):
        oy = y / scale
        y0 = int(np.floor(oy)) - 1
        for x in range(nw):
            ox = x / scale
            x0 = int(np.floor(ox)) - 1
            acc = np.zeros(c)
            wsum = 0.0
            for m in range(4):
                for n in range(4):
                    px = min(w - 1, max(0, x0 + m))
                    py = min(h - 1, max(0, y0 + n))
                    wx = float(cubic_keys(np.float64(ox - px), a=a))
                    wy = float(cubic_keys(np.float64(oy - py), a=a))
                    weight = wx * wy
                    acc += data[py, px] * weight
                    wsum += weight
            out[y, x] = js_round_u8(acc / wsum)
    return out


def adaptive_bicubic_oracle(img_u8: np.ndarray, scale: float, a: float = -0.5,
                            rows: np.ndarray | None = None) -> np.ndarray:
    """Vectorized float64 replica of ``ultimateBicubicInterpolation``
    (adaptive_bicubic_super_resolution.js:10-145).

    Non-separable: base Keys weights are modulated per tap by local luma
    contrast around the output pixel's nearest LR pixel. Notable JS quirks
    preserved: BT.709 luma from the *raw* u8 channels; the cubic weight is
    memoized on |t| rounded to 2 decimals (toFixed(2)); the center tap
    (px==centerX and py==centerY) is NOT modulated.

    ``rows`` (output row indices) evaluates those rows alone: each output
    pixel is computed from its own coordinates, so they are exact.
    """
    h, w, c = img_u8.shape
    nh, nw = out_size(h, scale), out_size(w, scale)
    data = img_u8.astype(np.float64)

    luma = (data[..., 0] * 0.2126 + data[..., 1] * 0.7152 + data[..., 2] * 0.0722)

    # 5x5 clamped-window variance of luma around each LR pixel (radius 2).
    pad = np.pad(luma, 2, mode="edge")
    win = np.lib.stride_tricks.sliding_window_view(pad, (5, 5))
    s = win.sum(axis=(-1, -2))
    sq = (win * win).sum(axis=(-1, -2))
    variance = (sq - s * s / 25.0) / 25.0
    is_flat = variance < 10.0
    is_edge = variance > 50.0

    if rows is not None:
        nh = len(rows)
    oy = (np.arange(nh) if rows is None else np.asarray(rows)) \
        .astype(np.float64) / scale
    ox = np.arange(nw, dtype=np.float64) / scale
    y0 = np.floor(oy).astype(np.int64) - 1
    x0 = np.floor(ox).astype(np.int64) - 1
    cy = np.clip(np.floor(oy + 0.5).astype(np.int64), 0, h - 1)  # JS Math.round
    cx = np.clip(np.floor(ox + 0.5).astype(np.int64), 0, w - 1)

    def cubic_memo(t):
        # JS memoizes on Math.abs(t).toFixed(2) => evaluate at 2-decimal
        # rounding. Approximation note: toFixed rounds the *binary* double
        # (e.g. (1.005).toFixed(2) === '1.00' because 1.005 is stored as
        # 1.00499…), whereas floor(|t|*100+0.5)/100 rounds the decimal value;
        # they differ only when |t|*100 lands exactly on a .5 quantization
        # boundary whose double representation falls below it. For this
        # kernel |t| is phase/scale plus an integer, so small integer scales
        # never hit such boundaries; the worst case elsewhere is a 1e-2
        # weight perturbation on one tap ≈ ≤1 u8 LSB — inside the parity
        # tolerance used everywhere.
        t = np.abs(t)
        t = np.floor(t * 100.0 + 0.5) / 100.0
        return cubic_keys(t, a=a)

    center_luma = luma[cy[:, None], cx[None, :]]           # [nh, nw]
    flat_r = is_flat[cy[:, None], cx[None, :]]
    edge_r = is_edge[cy[:, None], cx[None, :]]

    acc = np.zeros((nh, nw, c), dtype=np.float64)
    wsum = np.zeros((nh, nw), dtype=np.float64)
    for m in range(4):
        px = np.clip(x0 + m, 0, w - 1)                     # [nw]
        wx = cubic_memo(ox - px)
        for n in range(4):
            py = np.clip(y0 + n, 0, h - 1)                 # [nh]
            wy = cubic_memo(oy - py)
            base = wy[:, None] * wx[None, :]               # [nh, nw]
            tap_luma = luma[py[:, None], px[None, :]]
            ld = np.abs(center_luma - tap_luma)
            edge_w = base * (1.0 + 0.5 * np.minimum(1.0, ld / 50.0))
            flat_w = base * np.maximum(0.5, 1.0 - ld / 30.0)
            text_w = base * (0.8 + 0.4 * np.exp(-ld / 20.0))
            mod = np.where(edge_r, edge_w, np.where(flat_r, flat_w, text_w))
            is_center = (py[:, None] == cy[:, None]) & (px[None, :] == cx[None, :])
            weight = np.where(is_center, base, mod)
            acc += weight[..., None] * data[py[:, None], px[None, :]]
            wsum += weight
    return js_round_u8(acc / wsum[..., None])
