"""Plan-driven separable resize with direct u8 HWC delivery (CUDA kernel C).

Counterpart of ``bicubic_interpolation_model_tpu/ops/pallas_mxu.py``; the
kernel is ``csrc/resize_mxu.cu``. Any scale >= 1 whose reduced fraction has
a denominator <= 16 (integer scales included), all four separable methods,
C in 1..4, a batch in one launch:

    tmp[r, j, ch] = sum_k wy[r, k] * in[iy[r, k], j, ch]       (row pass)
    out[r, x, ch] = sum_t wx[x, t] * tmp[r, ix[x, t], ch]      (column pass)

in f32, from the two :class:`~..core.plan.AxisPlan` s (clamped taps already
folded: duplicate indices add). The kernel reads each plan as bands
(:func:`_bands`): per group of 4 consecutive outputs, the window of inputs
their taps reach and the dense weights there, so its sums run over each
output's taps in input order (zeros between them add nothing).
:func:`resize_mxu_reference` sums the plan's taps in their own order: the
two agree within 1 u8 LSB. uint8 in → JS-rounded
uint8 out (``clip(trunc(v + 0.5), 0, 255)``); float in → float out,
unrounded. The weights always use the reference's float division
``x / scale``; :func:`scale_fraction` only decides support.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import torch

from ..core import plan as planlib
from ..runtime import build
from ..runtime.device import as_device_tensor

#: the kernel's output tile (csrc/resize_mxu.cu): rows x pixels per block,
#: and the outputs of one band group along each axis
_TILE_R, _TILE_X = 32, 128
_GROUP = 4


def scale_fraction(scale: float, max_den: int = 16) -> Fraction | None:
    """``scale`` as a small rational p/q, or None when it has none within
    1e-9 (relative): the support predicate of the kernel. The *weights*
    always use exact float-division semantics."""
    fr = Fraction(float(scale)).limit_denominator(max_den)
    if fr.numerator <= 0 or abs(float(fr) - float(scale)) > 1e-9 * scale:
        return None
    return fr


def _tile_units(p: int, q: int, c: int) -> tuple[int, int]:
    """The JAX kernel's (row unit, column unit) tiling granules; kept only
    because :func:`mxu_supported` must answer as the JAX package's does."""
    row_unit = int(np.lcm(q * 8 // int(np.gcd(p, 8)), 8))
    col_unit = int(np.lcm(q * (128 // int(np.gcd(p * c, 128))),
                          128 // int(np.gcd(c, 128))))
    return row_unit, col_unit


def mxu_supported(scale, c: int, method: str = "bicubic") -> bool:
    """The JAX package's routing predicate, value for value: what its TPU
    kernel's tiler takes. Kept so both packages can be asked the same
    question; the CUDA kernel's own set is :func:`mxu_takes`, and that is
    what routes on the card."""
    if method not in ("nearest", "bilinear", "bicubic", "lanczos"):
        return False
    if c not in (1, 2, 3, 4):
        return False
    fr = scale_fraction(scale)
    if fr is None or fr < 1:
        return False
    ru, cu = _tile_units(fr.numerator, fr.denominator, 4 if c == 3 else c)
    return ru <= 128 and cu <= 1024


def mxu_takes(scale, c: int, method: str = "bicubic") -> bool:
    """True if :func:`resize_mxu` takes (scale, channels, method): any of
    the four separable methods, 1..4 channels, any scale >= 1 with a
    rational reduction (:func:`scale_fraction`). A superset of
    :func:`mxu_supported`: the CUDA kernel reads its windows from the plan,
    so no tiling granule limits it."""
    if method not in ("nearest", "bilinear", "bicubic", "lanczos"):
        return False
    fr = scale_fraction(scale)
    return 1 <= c <= 4 and fr is not None and fr >= 1


def flat_to_hwc_np(flat: np.ndarray, h_out: int, w_out: int, c: int,
                   out_c: int | None = None) -> np.ndarray:
    """Zero-copy HWC view of a fetched ``layout='flat'`` frame.

    ``flat`` is [rows, px*c] u8 whose leading [h_out, w_out*c] bytes ARE
    the interleaved image; a strided view reshapes without copying.
    ``out_c`` < c drops trailing channels."""
    r = np.lib.stride_tricks.as_strided(
        flat, shape=(h_out, w_out, c),
        strides=(flat.strides[0], c * flat.strides[1], flat.strides[1]))
    return r if out_c is None or out_c == c else r[..., :out_c]


def _apply_plan(x, idx, w, axis):
    """out[i] = sum_k w[i, k] * x[idx[i, k]] along ``axis``: gathers and
    multiply-adds over the taps in order."""
    shape = [1] * x.dim()
    shape[axis] = idx.shape[0]
    acc = None
    for k in range(idx.shape[1]):
        term = w[:, k].reshape(shape) * x.index_select(axis, idx[:, k])
        acc = term if acc is None else acc.add_(term)
    return acc


def resize_mxu_reference(img_bhwc: torch.Tensor, iy: torch.Tensor,
                         wy: torch.Tensor, ix: torch.Tensor,
                         wx: torch.Tensor,
                         dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The plain PyTorch version of the kernel: gather + multiply-add over
    the same plan arrays, row pass first, in ``dtype`` (``torch.float64``
    is the oracle on the card); the same rounding. [B, H, W, C] →
    [B, Ho, Wo, C]."""
    out_u8 = img_bhwc.dtype == torch.uint8
    iy, ix = iy.long(), ix.long()
    tmp = _apply_plan(img_bhwc.to(dtype), iy, wy.to(dtype), 1)
    out = _apply_plan(tmp, ix, wx.to(dtype), 2)
    if out_u8:
        return torch.clamp(torch.trunc(out.add_(0.5)), 0, 255).to(torch.uint8)
    return out.to(torch.float32)


def _bands(idx: np.ndarray, w: np.ndarray, groups_per_tile: int):
    """One axis plan as the kernel reads it: groups of ``_GROUP``
    consecutive outputs, each with the window [lo, lo + width) of inputs its
    taps reach and its dense weights there, band[g, j, i] for output
    ``g*_GROUP + i`` at input ``lo[g] + j`` (duplicate, clamped taps summed
    in float64, as ``plan_to_matrix`` does; zeros elsewhere and for outputs
    past the end). Groups are padded to whole tiles (zero weights, the last
    group's ``lo``). Returns (band f32 [n_g, width, 4], lo int32 [n_g])."""
    n_out, k = idx.shape
    n_t = -(-n_out // (_GROUP * groups_per_tile))
    n_g = n_t * groups_per_tile
    g = np.arange(n_out) // _GROUP
    lo = np.full(n_g, np.iinfo(np.int64).max)
    np.minimum.at(lo, g, idx.min(axis=1))
    lo[g[-1] + 1:] = lo[g[-1]]
    hi = np.zeros(n_g, np.int64)
    np.maximum.at(hi, g, idx.max(axis=1))
    width = int((hi[:g[-1] + 1] - lo[:g[-1] + 1]).max()) + 1
    band = np.zeros((n_g, width, _GROUP), np.float64)
    gg = np.repeat(g, k)
    np.add.at(band, (gg, idx.reshape(-1) - lo[gg],
                     np.repeat(np.arange(n_out) % _GROUP, k)),
              w.astype(np.float64).reshape(-1))
    return band.astype(np.float32), lo.astype(np.int32)


def _axis_operands(idx: np.ndarray, w: np.ndarray, tile: int):
    """One axis plan as kernel C reads it for a tile of ``tile`` outputs:
    (band, lo, tile_lo, window). ``band`` is :func:`_bands`' tap major per
    tile, f32 [n_tiles, width, tile / 4, 4]; ``tile_lo`` the least input
    index a tile's group windows start at and ``window`` the largest extent
    (greatest window end - that start) over the tiles: the input window the
    kernel stages per tile, from the plan itself, so any scale and any
    planner fit."""
    gpt = tile // _GROUP
    band, lo = _bands(idx, w, gpt)
    starts = lo.reshape(-1, gpt)
    tile_lo = starts.min(axis=1)
    window = int((starts.max(axis=1) + band.shape[1] - tile_lo).max())
    band = band.reshape(-1, gpt, band.shape[1], _GROUP).transpose(0, 2, 1, 3)
    return (np.ascontiguousarray(band), lo, tile_lo.astype(np.int32),
            window)


def _operands(method, h, w, scale, a, lanczos_a, device, weight_cache):
    """The two plans (for the plain version) and the kernel's operands
    (each axis's bands and tile windows, the output extents) as device
    arrays, cached per (h, w, scale, method, a, lanczos_a, device) in the
    caller's dict."""
    key = (h, w, float(scale), method, float(a), int(lanczos_a), str(device))
    cached = weight_cache.get(key) if weight_cache is not None else None
    if cached is None:
        kw = ({"a": a} if method == "bicubic"
              else {"a": lanczos_a} if method == "lanczos" else {})
        plan_y = planlib.plan_axis(method, h, float(scale), **kw)
        plan_x = planlib.plan_axis(method, w, float(scale), **kw)
        band_y, lo_y, row_lo, win_r = _axis_operands(plan_y.idx, plan_y.w,
                                                     _TILE_R)
        band_x, lo_x, col_lo, win_c = _axis_operands(plan_x.idx, plan_x.w,
                                                     _TILE_X)
        dev = lambda arr: torch.from_numpy(np.ascontiguousarray(arr)).to(
            device)
        cached = (dev(plan_y.idx), dev(plan_y.w), dev(plan_x.idx),
                  dev(plan_x.w), dev(band_y), dev(lo_y), dev(row_lo),
                  dev(band_x), dev(lo_x), dev(col_lo), win_r, win_c,
                  plan_y.n_out, plan_x.n_out)
        if weight_cache is not None:
            weight_cache[key] = cached
    return cached


def _launch(img, band_y, lo_y, row_lo, band_x, lo_x, col_lo, win_r, win_c,
            ho, wo):
    b, h, w, c = img.shape
    out_u8 = img.dtype == torch.uint8
    img = img.contiguous()
    out = torch.empty((b, ho, wo, c), device=img.device,
                      dtype=torch.uint8 if out_u8 else torch.float32)
    if out.numel():
        lib = build.library()
        with torch.cuda.device(img.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc = lib.bim_resize_mxu(
                img.data_ptr(), int(out_u8), band_y.data_ptr(),
                lo_y.data_ptr(), row_lo.data_ptr(), band_x.data_ptr(),
                lo_x.data_ptr(), col_lo.data_ptr(), out.data_ptr(), b, h, w,
                c, ho, wo, band_y.shape[1], band_x.shape[1], win_r, win_c,
                stream)
        if rc == -1:
            raise ValueError(
                f"resize_mxu: a {win_r}x{win_c} input window per tile needs "
                "more shared memory than a block has")
        build.check(rc, "resize_mxu")
        resize_mxu.launches += 1
    return out


def resize_mxu(img, scale, method: str = "bicubic", *, a: float = -0.5,
               lanczos_a: int = 3, layout: str = "hwc",
               weight_cache: dict | None = None, device=None):
    """u8 (or float) HW / HWC / BHWC input, any scale >= 1 with a small
    rational reduction (see :func:`mxu_takes`). A tensor runs where it lies:
    a CUDA tensor launches the kernel (or raises), a CPU tensor runs
    :func:`resize_mxu_reference`. A numpy frame is moved to ``device``, the
    card by default: without a card that raises unless ``device="cpu"``.

    ``layout="hwc"`` returns [.., H_out, W_out, C]. ``layout="flat"`` (BHWC
    input only) returns [B, H_out, W_out*C], whose bytes ARE the interleaved
    image: :func:`flat_to_hwc_np` views a fetched frame with no copy.
    ``weight_cache`` (a dict the caller owns) keeps per-size device plan
    arrays across calls, so a steady stream uploads only its frames."""
    if layout not in ("hwc", "flat"):
        raise ValueError(f"unknown layout {layout!r}")
    fr = scale_fraction(scale)
    if fr is None or fr < 1:
        raise ValueError(f"resize_mxu requires scale >= 1 with a small "
                         f"rational reduction (got {scale!r})")
    img = as_device_tensor(img, device)
    squeeze_hw = img.dim() == 2
    if squeeze_hw:
        img = img[..., None]
    squeeze_b = img.dim() == 3
    if squeeze_b:
        img = img[None]
    if img.dim() != 4:
        raise ValueError("expected an HW, HWC or BHWC image, got shape "
                         f"{tuple(img.shape)}")
    if layout == "flat" and (squeeze_hw or squeeze_b):
        raise ValueError("layout='flat' requires BHWC input")
    b, h, w, c = img.shape
    if not 1 <= c <= 4:
        raise ValueError(f"resize_mxu takes 1 <= C <= 4 channels, got {c}")
    in_dtype = img.dtype
    if in_dtype != torch.uint8:
        img = img.to(torch.float32)
    ops = _operands(method, h, w, scale, a, lanczos_a, img.device,
                    weight_cache)
    if img.device.type == "cpu":
        out = resize_mxu_reference(img, *ops[:4])
    elif img.device.type == "cuda":
        out = _launch(img, *ops[4:])
    else:
        raise ValueError(f"unsupported device {img.device}")
    if in_dtype != torch.uint8:
        out = out.to(in_dtype)
    if layout == "flat":
        return out.reshape(b, out.shape[1], out.shape[2] * c)
    if squeeze_b:
        out = out[0]
    return out[..., 0] if squeeze_hw else out


resize_mxu.launches = 0
