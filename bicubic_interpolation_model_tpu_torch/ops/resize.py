"""Device-side resize ops (PyTorch): counterpart of
``bicubic_interpolation_model_tpu/ops/resize.py``.

Three interchangeable plain implementations of the same separable semantics
(defined by :mod:`..core.plan`; parity vs the float64 oracle is ±1 u8 LSB):

``gather``  index_select + multiply-add per axis. Any scale, any device; the
            correctness reference on the device.
``matmul``  out = M_row @ img @ M_col^T per channel: two dense
            sampling-matrix products in f32 (TF32 off). Any scale.
``phase``   4-tap kernels at integer or small-rational upscales: interior
            weights are periodic in the output index, so each pass is 4
            shifted-slice multiply-adds and a phase interleave; the border
            band (where the reference's clamp semantics act) is patched
            with the exact gather rows.

The three CUDA kernels are reached through the JAX package's ``impl`` names:
``pallas_mxu`` (:mod:`.mxu`, kernel C), ``pallas_phase`` (:mod:`.phase`,
kernel D) and ``pallas`` (:mod:`.banded`, kernel F, integer scales).
``impl="auto"`` on a CUDA device takes kernel C for everything
that kernel takes (:func:`~.mxu.mxu_takes`: the four methods, 1..4 channels,
any scale >= 1 with a rational reduction, integer scales included). Only
what no kernel takes (more than 4 channels, a downscale, a scale with no
small rational form) goes to the plain graph there (``phase`` for bicubic
integer scales, ``matmul`` otherwise), as every ``auto`` request does on the
CPU. Kernels D and F are reached by name. This one function owns the dispatch:
:class:`~..serving.Upscaler` calls it with its weight cache and routes
nothing itself.

Layout: the public API is HWC (or BHWC for :func:`resize_batch`);
internally [..., C, H, W].
"""

from __future__ import annotations

from fractions import Fraction
from typing import Literal

import numpy as np
import torch

from ..core import plan as planlib
from ..core.plan import AxisPlan
from ..runtime.device import full_f32_matmul, resolve_device
from ..utils.profiling import span

#: the classical methods by name, as the JAX package types them
Method = Literal["nearest", "bilinear", "bicubic", "lanczos"]


def round_u8(x: torch.Tensor) -> torch.Tensor:
    """JS Math.round + Uint8ClampedArray store: clip(floor(v+0.5), 0, 255)."""
    return torch.clamp(torch.floor(x + 0.5), 0, 255).to(torch.uint8)


def _dev(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr)).to(like.device)


# ---------------------------------------------------------------------------
# gather implementation
# ---------------------------------------------------------------------------

def _axis_pass_gather(x: torch.Tensor, plan: AxisPlan, axis: int):
    axis = axis % x.dim()
    g = x.index_select(axis, _dev(plan.idx.reshape(-1), x).long())
    shape = list(g.shape)
    shape[axis:axis + 1] = [plan.n_out, plan.taps]
    wshape = [1] * (x.dim() + 1)
    wshape[axis], wshape[axis + 1] = plan.n_out, plan.taps
    return (g.reshape(shape) * _dev(plan.w, x).reshape(wshape)).sum(axis + 1)


def _resize_gather(chw, plan_y: AxisPlan, plan_x: AxisPlan):
    t = _axis_pass_gather(chw, plan_y, axis=-2)
    return _axis_pass_gather(t, plan_x, axis=-1)


# ---------------------------------------------------------------------------
# matmul implementation
# ---------------------------------------------------------------------------

def _resize_matmul(chw, plan_y: AxisPlan, plan_x: AxisPlan):
    m_row = _dev(planlib.plan_to_matrix(plan_y), chw)            # [Ho, Hi]
    m_col_t = _dev(planlib.plan_to_matrix(plan_x).T, chw)        # [Wi, Wo]
    with full_f32_matmul():
        t = torch.einsum("oh,...hw->...ow", m_row, chw)
        return torch.einsum("...ow,wx->...ox", t, m_col_t)


# ---------------------------------------------------------------------------
# phase-decomposed implementation (4-tap kernels)
# ---------------------------------------------------------------------------

def _exact_rows(x, plan: AxisPlan, lo: int, hi: int):
    """Rows [lo, hi) of the plan applied to ``x`` along axis 0 (gather)."""
    g = x[_dev(plan.idx[lo:hi], x).long()]                       # [n, K, ...]
    w = _dev(plan.w[lo:hi], x).reshape(
        plan.w[lo:hi].shape + (1,) * (x.dim() - 1))
    return (g * w).sum(dim=1)


def _axis_pass_phase(x, plan: AxisPlan, axis: int, scale: int):
    """Interior via periodic phase weights (shifted-slice multiply-add),
    borders via the exact gather rows. Requires n_out == scale * n_in."""
    n_in = plan.n_in
    lo, hi = planlib.interior_band(n_in, scale)
    if hi <= lo:  # image too small for an interior band
        return _axis_pass_gather(x, plan, axis)

    x = x.movedim(axis, 0)
    padded = torch.cat([x[:1], x, x[-1:], x[-1:]])               # edge (1, 2)
    # interior weights = exact plan rows for one full period
    lut = _dev(plan.w[lo:lo + scale], x)                         # [S, 4]
    slices = torch.stack([padded[k:k + n_in] for k in range(4)])
    tmp = torch.einsum("pm,mh...->hp...", lut, slices)           # [n_in, S, ...]
    interior = tmp.reshape((n_in * scale,) + x.shape[1:])
    out = torch.cat([_exact_rows(x, plan, 0, lo), interior[lo:hi],
                     _exact_rows(x, plan, hi, plan.n_out)])
    return out.movedim(0, axis)


def _axis_pass_phase_rational(x, plan: AxisPlan, axis: int, p: int, q: int):
    """Rational-scale (p/q) phase pass: interior weights are periodic with
    period ``p`` in the output index. For output o = k*p + r the 4 taps sit
    at k*q + t(r) + m with t(r) = floor(r*q/p) - 1, so each phase r is a
    4-tap multiply-add over stride-q slices of the input, interleaved by a
    [n_k, p] reshape. Borders come from the exact gather rows."""
    n_in, n_out = plan.n_in, plan.n_out
    # interior periods k: all taps in-bounds for every phase
    k0 = 1                                            # k*q + t(r) >= 0
    k1 = (n_in - 2 - q) // q                          # k*q+q-1+2 <= n_in-1
    lo, hi = k0 * p, (k1 + 1) * p
    if hi > n_out:                                    # rounding of n_out
        hi -= p
        k1 -= 1
    if k1 < k0:
        return _axis_pass_gather(x, plan, axis)
    n_k = k1 - k0 + 1

    x = x.movedim(axis, 0)
    tr = [int(np.floor(r * q / p)) - 1 for r in range(p)]
    # phase weights: the plan rows of the first interior period (k-invariant)
    lut = plan.w[lo:lo + p]                           # [p, 4]
    phases = []
    for r in range(p):
        acc = None
        for m in range(4):
            start = k0 * q + tr[r] + m
            term = float(lut[r, m]) * x[start:start + n_k * q:q]
            acc = term if acc is None else acc + term
        phases.append(acc)
    interior = torch.stack(phases, dim=1).reshape((n_k * p,) + x.shape[1:])
    out = torch.cat([_exact_rows(x, plan, 0, lo), interior,
                     _exact_rows(x, plan, hi, n_out)])
    return out.movedim(0, axis)


def _as_fraction(scale: float, max_den: int = 64) -> tuple[int, int] | None:
    """scale as p/q with small q (exactly — floats like 1.5, 2.5 are exact)."""
    f = Fraction(scale).limit_denominator(max_den)
    if float(f) != float(scale) or f < 1:
        return None
    return f.numerator, f.denominator


def _resize_phase(chw, plan_y: AxisPlan, plan_x: AxisPlan, scale: float):
    if _is_integer_upscale(scale):
        t = _axis_pass_phase(chw, plan_y, axis=-2, scale=int(scale))
        return _axis_pass_phase(t, plan_x, axis=-1, scale=int(scale))
    p, q = _as_fraction(scale)
    t = _axis_pass_phase_rational(chw, plan_y, axis=-2, p=p, q=q)
    return _axis_pass_phase_rational(t, plan_x, axis=-1, p=p, q=q)


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def _is_integer_upscale(scale: float) -> bool:
    return scale >= 1 and float(scale) == int(scale)


def build_plans(h: int, w: int, scale: float, method: str,
                **kw) -> tuple[AxisPlan, AxisPlan]:
    return (planlib.plan_axis(method, h, scale, **kw),
            planlib.plan_axis(method, w, scale, **kw))


def _resize_graph(img, scale, method, impl, a, lanczos_a):
    """The plain implementations on a [(B,) H, W(, C)] tensor where it lies
    (``img.dim() == 2`` is a gray frame; a batch always carries C)."""
    kw = {}
    if method == "bicubic":
        kw["a"] = a
    elif method == "lanczos":
        kw["a"] = lanczos_a
    squeeze = img.dim() == 2
    if squeeze:
        img = img[..., None]
    h, w = img.shape[-3:-1]
    plan_y, plan_x = build_plans(h, w, scale, method, **kw)
    in_dtype = img.dtype
    chw = img.movedim(-1, -3).to(torch.float32)

    if impl == "auto":
        # the phase path only covers 4-tap kernels; the others use matmul
        impl = ("phase" if _is_integer_upscale(scale) and method == "bicubic"
                else "matmul")
    if impl == "gather":
        out = _resize_gather(chw, plan_y, plan_x)
    elif impl == "matmul":
        out = _resize_matmul(chw, plan_y, plan_x)
    elif impl == "phase":
        if plan_y.taps != 4 or (not _is_integer_upscale(scale)
                                and _as_fraction(scale) is None):
            raise ValueError(
                "phase impl requires a 4-tap kernel and an integer or "
                "small-rational (p/q, q<=64) upscale")
        out = _resize_phase(chw, plan_y, plan_x, scale)
    else:
        raise ValueError(f"unknown impl {impl!r}")

    out = out.movedim(-3, -1)
    if squeeze:
        out = out[..., 0]
    if in_dtype == torch.uint8:
        return round_u8(out)
    return out.to(in_dtype)


def _resize(img, scale, method, impl, a, lanczos_a, device, batched,
            weight_cache=None):
    dev = resolve_device(device)
    with span("serve.upload"):
        img = torch.as_tensor(img).to(dev)
    with span("resize.dispatch"):
        return _dispatch(img, scale, method, impl, a, lanczos_a, dev,
                         batched, weight_cache)


def _dispatch(img, scale, method, impl, a, lanczos_a, dev, batched,
              weight_cache):
    """The route of a tensor on ``dev``: a kernel's wrapper (with the
    caller's plan cache) or the plain graph."""
    want = (3, 4) if batched else (2, 3)
    if img.dim() not in want:
        raise ValueError(f"expected an image of {want[0]} or {want[1]} "
                         f"dimensions, got shape {tuple(img.shape)}")
    if batched and img.dim() == 3:
        img = img[..., None]                    # [B, H, W] gray frames
        return _dispatch(img, scale, method, impl, a, lanczos_a, dev,
                         True, weight_cache)[..., 0]
    if impl == "auto" and dev.type == "cuda":
        from .mxu import mxu_takes
        c = img.shape[-1] if img.dim() - batched == 3 else 1
        if mxu_takes(scale, c, method):
            impl = "pallas_mxu"
    if impl == "pallas_mxu":
        from .mxu import resize_mxu
        return resize_mxu(img, scale, method, a=a, lanczos_a=lanczos_a,
                          weight_cache=weight_cache)
    if impl == "pallas":
        from .banded import resize_banded
        return resize_banded(img, scale, method, a=a, lanczos_a=lanczos_a,
                             weight_cache=weight_cache)
    if impl == "pallas_phase":
        from .phase import resize_phase
        return resize_phase(img, scale, method=method, a=a,
                            lanczos_a=lanczos_a, weight_cache=weight_cache)
    return _resize_graph(img, float(scale), method, impl, float(a),
                         int(lanczos_a))


def resize(img, scale: float, method: str = "bicubic", *,
           impl: str = "auto", a: float = -0.5, lanczos_a: int = 3,
           device="cuda", weight_cache: dict | None = None):
    """Resize an HW or HWC image (numpy or tensor) by ``scale`` with the
    reference's semantics; returns a tensor on ``device`` (the card by
    default: without one it raises unless given ``device="cpu"``).

    uint8 input → uint8 output (JS rounding); float input → float output.
    ``impl``: auto | gather | matmul | phase | pallas_mxu | pallas_phase |
    pallas.
    ``weight_cache`` (a dict the caller owns) keeps the kernels' per-size
    device plan arrays across calls.
    """
    return _resize(img, scale, method, impl, a, lanczos_a, device, False,
                   weight_cache)


def resize_batch(imgs, scale: float, method: str = "bicubic", *,
                 impl: str = "auto", a: float = -0.5, lanczos_a: int = 3,
                 device="cuda", weight_cache: dict | None = None):
    """:func:`resize` over a leading batch axis of same-size images
    ([B, H, W] or [B, H, W, C]) in one pass: the batch is a tensor
    dimension (and ``blockIdx.z`` of the kernels), not a loop."""
    return _resize(imgs, scale, method, impl, a, lanczos_a, device, True,
                   weight_cache)
