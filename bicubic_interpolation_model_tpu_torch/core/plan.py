"""Axis resampling plans — the separable heart of the framework.

Every classical interpolator in the reference (nearest / bilinear / bicubic /
lanczos) factors into two independent 1-D passes because

  * tap weights are a separable product w = wx(x-tap) * wy(y-tap), and
  * the per-pixel normalization sum factors: sum(wx*wy) = sum(wx)*sum(wy),

so dividing by the 2-D weight sum equals normalizing each axis on its own.
This holds *including* the reference's edge handling (taps clamped to the
image, weights evaluated at the clamped positions) because clamping acts
per-axis. See reference version3.0/utils/bicubic_super_resolution.js:35-80.

An :class:`AxisPlan` captures one 1-D pass: for each output index ``i`` a fixed
number of taps ``K`` with input indices ``idx[i, k]`` (already clamped
in-bounds) and weights ``w[i, k]`` (already normalized). Applying a plan is

    out[i] = sum_k w[i, k] * inp[idx[i, k]]

which the device-side ops realize three ways:

  1. gather + FMA (``index_select``) — exact, any device;
  2. dense sampling-matrix matmul (``plan_to_matrix``);
  3. phase-decomposed FMA for integer scales (``phase_lut_bicubic`` +
     ``interior_band``), where interior weights are periodic with period
     ``scale``.

All plan construction is NumPy float64 on host; weights are emitted float32.
The port's own copy of ``bicubic_interpolation_model_tpu/core/plan.py``: its
``idx`` (int32) and ``w`` (float32) equal the JAX package's bit for bit
(``tests/test_torch_core.py``), so everything downstream inherits the same
clamp semantics.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .kernels import cubic_keys, lanczos


@dataclasses.dataclass(frozen=True)
class AxisPlan:
    """One 1-D resampling pass.

    idx: int32 [n_out, K]  clamped input indices per output element
    w:   float32 [n_out, K] normalized weights per output element
    n_in, n_out, scale: geometry this plan was built for
    """

    idx: np.ndarray
    w: np.ndarray
    n_in: int
    n_out: int
    scale: float

    @property
    def taps(self) -> int:
        return self.idx.shape[1]


def out_size(n_in: int, scale: float) -> int:
    """Output size convention of the reference: round(n * scale).

    (reference bicubic_super_resolution.js:19-20)
    """
    return int(np.floor(n_in * scale + 0.5))


def _source_coords(n_out: int, scale: float) -> np.ndarray:
    """Corner-aligned source coordinates ox = x / scale (reference :38-39)."""
    return np.arange(n_out, dtype=np.float64) / scale


def plan_bicubic(n_in: int, scale: float, a: float = -0.5,
                 n_out: int | None = None) -> AxisPlan:
    """Keys-cubic 4-tap plan with the reference's exact edge semantics.

    Taps at clip(floor(ox)-1 + m, 0, n_in-1) for m in 0..3; the weight is
    evaluated at the *clamped* tap position (cubicWeight(ox - px)), then the
    4 weights are normalized to sum 1 (per-axis factor of the reference's 2-D
    normalization). reference bicubic_super_resolution.js:42-78.
    """
    n_out = out_size(n_in, scale) if n_out is None else n_out
    ox = _source_coords(n_out, scale)
    x0 = np.floor(ox).astype(np.int64) - 1
    m = np.arange(4)
    idx = np.clip(x0[:, None] + m[None, :], 0, n_in - 1)
    w = cubic_keys(ox[:, None] - idx, a=a)
    w = w / w.sum(axis=1, keepdims=True)
    return AxisPlan(idx.astype(np.int32), w.astype(np.float32),
                    n_in, n_out, scale)


def plan_bilinear(n_in: int, scale: float, n_out: int | None = None) -> AxisPlan:
    """2-tap triangle plan.

    x1 = floor(ox); x2 = min(n-1, x1+1); weights (1-dx, dx) with dx = ox - x1
    evaluated at the *unclamped* position and NOT renormalized
    (reference bilinear_super_resolution.js:26-37).
    """
    n_out = out_size(n_in, scale) if n_out is None else n_out
    ox = _source_coords(n_out, scale)
    x1 = np.floor(ox).astype(np.int64)
    x2 = np.minimum(n_in - 1, x1 + 1)
    dx = ox - x1
    idx = np.stack([np.clip(x1, 0, n_in - 1), x2], axis=1)
    w = np.stack([1.0 - dx, dx], axis=1)
    return AxisPlan(idx.astype(np.int32), w.astype(np.float32),
                    n_in, n_out, scale)


def plan_nearest(n_in: int, scale: float, n_out: int | None = None) -> AxisPlan:
    """1-tap plan: idx = clip(round(x/scale)) with JS round-half-up
    (reference nearestNeighbor_super_resolution.js:28-33)."""
    n_out = out_size(n_in, scale) if n_out is None else n_out
    ox = _source_coords(n_out, scale)
    idx = np.clip(np.floor(ox + 0.5).astype(np.int64), 0, n_in - 1)
    return AxisPlan(idx.astype(np.int32)[:, None],
                    np.ones((n_out, 1), dtype=np.float32),
                    n_in, n_out, scale)


def plan_lanczos(n_in: int, scale: float, a: int = 3,
                 n_out: int | None = None) -> AxisPlan:
    """Lanczos-a plan (2a taps) with the reference's clipped-window semantics.

    Window [max(0, floor(ox)-a+1), min(n-1, floor(ox)+a)]; weights evaluated at
    the in-window positions, taps outside the window dropped (weight 0), then
    normalized by the in-window sum (reference lanczos_super_resolution.js:32-68).
    """
    n_out = out_size(n_in, scale) if n_out is None else n_out
    ox = _source_coords(n_out, scale)
    base = np.floor(ox).astype(np.int64) - a + 1
    m = np.arange(2 * a)
    pos = base[:, None] + m[None, :]
    in_window = (pos >= 0) & (pos <= n_in - 1)
    idx = np.clip(pos, 0, n_in - 1)
    w = lanczos(ox[:, None] - pos, a=a)
    w = np.where(in_window, w, 0.0)
    w = w / w.sum(axis=1, keepdims=True)
    return AxisPlan(idx.astype(np.int32), w.astype(np.float32),
                    n_in, n_out, scale)


_PLANNERS = {
    "nearest": plan_nearest,
    "bilinear": plan_bilinear,
    "bicubic": plan_bicubic,
    "lanczos": plan_lanczos,
}


def plan_axis(method: str, n_in: int, scale: float, **kw) -> AxisPlan:
    try:
        planner = _PLANNERS[method]
    except KeyError:
        raise ValueError(
            f"unknown method {method!r}; expected one of {sorted(_PLANNERS)}"
        ) from None
    return planner(n_in, scale, **kw)


def plan_to_matrix(plan: AxisPlan, dtype=np.float32) -> np.ndarray:
    """Densify a plan into a sampling matrix M [n_out, n_in] so that one axis
    pass is ``out = M @ inp``. Duplicate (clamped) taps accumulate — exactly the
    reference's behavior of adding a second weight for the same source pixel."""
    mat = np.zeros((plan.n_out, plan.n_in), dtype=np.float64)
    rows = np.repeat(np.arange(plan.n_out), plan.taps)
    np.add.at(mat, (rows, plan.idx.reshape(-1)), plan.w.astype(np.float64).reshape(-1))
    return mat.astype(dtype)


_DOWN_KERNELS = {
    # kernel function and half-support (in kernel units)
    "box": (lambda t: (np.abs(np.asarray(t, np.float64)) <= 0.5).astype(np.float64), 0.5),
    "triangle": (lambda t: np.maximum(0.0, 1.0 - np.abs(np.asarray(t, np.float64))), 1.0),
    "cubic": (cubic_keys, 2.0),
    "lanczos2": (lambda t: lanczos(t, a=2), 2.0),
    "lanczos3": (lambda t: lanczos(t, a=3), 3.0),
}


def plan_downsample(n_in: int, factor: float, method: str = "cubic",
                    n_out: int | None = None) -> AxisPlan:
    """Antialiased downsample plan (the role sharp's ``resize`` plays for
    HR→LR generation, reference data_generator.js:62-88 /
    model_super_resolution.js:20-32).

    Center-aligned mapping src = (dst+0.5)*factor - 0.5 with the kernel
    stretched by ``factor`` (antialiasing), taps clamped to the image and
    weights normalized. Exact parity with libvips is not a goal (its kernels
    are its own); this is the standard convention shared by PIL/OpenCV.
    """
    if factor < 1:
        raise ValueError("factor must be >= 1 for downsampling")
    n_out = int(n_in // factor) if n_out is None else n_out
    # "bicubic" (the upscale-side name everywhere else in the package) is
    # the same Keys kernel the down table registers as "cubic" (sharp's
    # name for it, data_generator.js:62-88) — accept both spellings
    kern, half = _DOWN_KERNELS["cubic" if method == "bicubic" else method]
    support = half * factor
    taps = int(np.ceil(2 * support)) + 1
    center = (np.arange(n_out, dtype=np.float64) + 0.5) * factor - 0.5
    first = np.ceil(center - support).astype(np.int64)
    k = np.arange(taps)
    pos = first[:, None] + k[None, :]
    w = kern((pos - center[:, None]) / factor)
    idx = np.clip(pos, 0, n_in - 1)
    w = w / w.sum(axis=1, keepdims=True)
    return AxisPlan(idx.astype(np.int32), w.astype(np.float32),
                    n_in, n_out, 1.0 / factor)


def phase_lut_bicubic(scale: int, a: float = -0.5) -> np.ndarray:
    """Interior weight LUT [scale, 4] for integer upscales.

    For interior output x = scale*X + p the taps are X-1..X+2 and the weights
    depend only on the phase p: w[p, m] = cubic(p/scale + 1 - m), normalized.
    """
    p = np.arange(scale, dtype=np.float64) / scale
    m = np.arange(4, dtype=np.float64)
    w = cubic_keys(p[:, None] + 1.0 - m[None, :])
    w = w / w.sum(axis=1, keepdims=True)
    return w.astype(np.float32)


def interior_band(n_in: int, scale: int) -> tuple[int, int]:
    """Output index range [lo, hi) where the interior phase LUT is exact.

    Outputs with floor(ox) == 0 (x < scale) touch the left clamp; outputs with
    floor(ox) >= n_in-2 (x >= scale*(n_in-2)) touch the right clamp. Between
    them the 4 taps are all in-bounds and weights are phase-periodic.
    """
    return scale, scale * (n_in - 2)
