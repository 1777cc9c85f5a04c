"""Adaptive bicubic ops (counterpart of
``bicubic_interpolation_model_tpu/ops/adaptive.py``).

1. :func:`adaptive_resize` / :func:`adaptive_resize_batch`: Keys weights
   modulated per tap by local luma contrast, at an integer scale S. Not
   separable (the modulation couples the axes). All quirks of the reference
   are kept for parity with the float64 oracle:

   * cubic weights quantize ``|t|`` to 2 decimals and are evaluated at the
     *clamped* tap positions, on the host in float64;
   * the modulation skips the tap that coincides with the centre pixel by
     *position equality*, which at image borders also exempts clamped
     duplicates;
   * region classes from the 5x5 variance of the BT.709 luma of the raw u8
     channels (flat < 10, edge > 50, edge wins), read at the clamped centre,
     and the three modulation laws. A frame of fewer than 3 channels reads
     its last channel for the ones it lacks (:func:`luma_bt709`), as the
     JAX package's clamped indexing does.

   These two functions are the one place that routes adaptive frames: on a
   CUDA device ``impl="auto"`` takes the fused kernel
   (:mod:`.adaptive_fused`, kernel E) for everything it takes
   (:func:`~.adaptive_fused.fused_takes`: uint8, 1 to 4 channels, every
   integer scale), the plain graph :func:`_adaptive_resize_u8` only for the
   rest (more than 4 channels, which ``impl="pallas"`` refuses);
   on the CPU ``auto`` is the plain graph. ``impl="pallas"`` forces the
   kernel's route (its plain version on the CPU), ``impl="jnp"`` the plain
   graph: the JAX package's names.

2. :func:`adaptive_gt_factors`: the data-generation variant, per-tap
   factors from a 4x4 LR luma window (contrast = max-min on [0,1] luma;
   edge > 0.3, flat < 0.1).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.kernels import cubic_keys
from ..runtime.device import resolve_device
from ..utils.profiling import span
from .resize import round_u8

#: region classes of a centre pixel, as the kernel and the plain versions
#: code them
TEXTURE, FLAT, EDGE = 0, 1, 2


def _cubic_memo_np(t, a: float = -0.5):
    """Keys cubic at |t| rounded to 2 decimals (the reference memoizes on
    ``toFixed(2)``), float64."""
    t = np.abs(np.asarray(t, np.float64))
    t = np.floor(t * 100.0 + 0.5) / 100.0
    return cubic_keys(t, a=a)


def luma_bt709(img: torch.Tensor) -> torch.Tensor:
    """BT.709 luma of the first three channels of a [..., C] float frame,
    summed in this order. With C < 3 channel ``min(i, C - 1)`` stands in for
    channel i (the JAX package indexes with jnp's clamping), so a gray
    frame's luma is ``(v*0.2126 + v*0.7152) + v*0.0722``, not ``v``: a
    region class can flip on the last bit at a threshold."""
    c = img.shape[-1]
    r, g, b = (img[..., min(i, c - 1)] for i in range(3))
    return r * 0.2126 + g * 0.7152 + b * 0.0722


def _edge_pad(x: torch.Tensor, top: int, bottom: int, left: int, right: int,
              row_dim: int, col_dim: int) -> torch.Tensor:
    """Edge-replicate padding of two dimensions (index clamping)."""
    h, w = x.shape[row_dim], x.shape[col_dim]
    iy = torch.arange(-top, h + bottom, device=x.device).clamp_(0, h - 1)
    ix = torch.arange(-left, w + right, device=x.device).clamp_(0, w - 1)
    return x.index_select(row_dim, iy).index_select(col_dim, ix)


def _variance5x5(luma: torch.Tensor) -> torch.Tensor:
    """5x5 clamped-window variance of a [..., H, W] luma: the 25 taps summed
    row by row, ``(sq - s*s/25)/25``. The divisor is a tensor on the luma's
    device so that the card divides too (a Python scalar would be turned
    into a multiplication by its reciprocal there, and a class could flip
    at a threshold)."""
    h, w = luma.shape[-2:]
    p = _edge_pad(luma, 2, 2, 2, 2, -2, -1)
    s = torch.zeros_like(luma)
    sq = torch.zeros_like(luma)
    for dy in range(5):
        for dx in range(5):
            v = p[..., dy:dy + h, dx:dx + w]
            s = s + v
            sq = sq + v * v
    n = torch.full((), 25.0, dtype=luma.dtype, device=luma.device)
    return (sq - s * s / n) / n


def region_classes(luma: torch.Tensor) -> torch.Tensor:
    """uint8 [..., H, W] class of each pixel as a centre: ``EDGE`` where the
    5x5 variance exceeds 50, else ``FLAT`` where it is below 10, else
    ``TEXTURE``."""
    var = _variance5x5(luma)
    cls = torch.full(var.shape, TEXTURE, dtype=torch.uint8, device=var.device)
    cls[var < 10.0] = FLAT
    cls[var > 50.0] = EDGE
    return cls


def centre_offset(phase: int, scale: int) -> int:
    """Centre variant of an output phase: round-half-up of ``phase/scale``
    in [0, 1), so 1 from the middle phase on."""
    return int(phase / scale >= 0.5)


def _adaptive_resize_u8(img: torch.Tensor, scale: int, a: float):
    """The plain graph on a [..., H, W, C] uint8 tensor where it lies: S^2
    vectorized passes over 16 pre-sliced tap planes, then a phase
    interleave; f32 on the device, weights from the host in float64."""
    h, w, c = img.shape[-3:]
    x = img.to(torch.float32)
    luma = luma_bt709(x)
    rows, cols = x.dim() - 3, x.dim() - 2

    cls = region_classes(luma)

    # tap planes: padded by (1 top/left, 2 bottom/right) == index clamping
    xp = _edge_pad(x, 1, 2, 1, 2, rows, cols)
    lp = _edge_pad(luma, 1, 2, 1, 2, -2, -1)
    tap_pix = [[xp[..., n:n + h, m:m + w, :] for m in range(4)]
               for n in range(4)]
    tap_lum = [[lp[..., n:n + h, m:m + w] for m in range(4)]
               for n in range(4)]

    # centre variants: offsets {0, 1} per axis (round(ox) is base or base+1)
    lp1 = _edge_pad(luma, 0, 1, 0, 1, -2, -1)
    cp1 = _edge_pad(cls, 0, 1, 0, 1, -2, -1)

    def axis_weights(n_in, phase_over_scale, tap):
        base = np.arange(n_in, dtype=np.float64)
        pos = np.clip(base + tap - 1, 0, n_in - 1)
        wgt = _cubic_memo_np(base + phase_over_scale - pos, a)
        return torch.from_numpy(wgt.astype(np.float32)).to(img.device)

    def mask(arr):
        return torch.from_numpy(arr).to(img.device)

    # the modulation factor depends only on the centre variant and the tap,
    # so the phases of a group share its 16 maps
    phase_groups: dict = {}
    for p in range(scale):
        phase_groups.setdefault(centre_offset(p, scale), []).append(p)

    out = torch.empty(img.shape[:-3] + (h, scale, w, scale, c),
                      dtype=torch.float32, device=img.device)
    for cy_off, pys in phase_groups.items():
        for cx_off, pxs in phase_groups.items():
            cl = lp1[..., cy_off:cy_off + h, cx_off:cx_off + w]
            k = cp1[..., cy_off:cy_off + h, cx_off:cx_off + w]
            cy_pos = np.clip(np.arange(h) + cy_off, 0, h - 1)
            cx_pos = np.clip(np.arange(w) + cx_off, 0, w - 1)
            fmaps = [[None] * 4 for _ in range(4)]
            for n in range(4):
                eq_y = mask(np.clip(np.arange(h) + n - 1, 0, h - 1) == cy_pos)
                for m in range(4):
                    eq_x = mask(
                        np.clip(np.arange(w) + m - 1, 0, w - 1) == cx_pos)
                    ld = (cl - tap_lum[n][m]).abs()
                    edge_f = 1.0 + 0.5 * torch.clamp(ld / 50.0, max=1.0)
                    flat_f = torch.clamp(1.0 - ld / 30.0, min=0.5)
                    text_f = 0.8 + 0.4 * torch.exp(-ld / 20.0)
                    fmap = torch.where(k == EDGE, edge_f,
                                       torch.where(k == FLAT, flat_f, text_f))
                    eq = eq_y[:, None] & eq_x[None, :]
                    fmaps[n][m] = torch.where(eq, torch.ones_like(fmap), fmap)

            for py in pys:
                wys = [axis_weights(h, py / scale, n)[:, None]
                       for n in range(4)]
                for px in pxs:
                    wxs = [axis_weights(w, px / scale, m)[None, :]
                           for m in range(4)]
                    acc = torch.zeros(img.shape, dtype=torch.float32,
                                      device=img.device)
                    wsum = torch.zeros(img.shape[:-1], dtype=torch.float32,
                                       device=img.device)
                    for n in range(4):
                        for m in range(4):
                            wgt = wys[n] * wxs[m] * fmaps[n][m]
                            acc = acc + wgt[..., None] * tap_pix[n][m]
                            wsum = wsum + wgt
                    out[..., :, py, :, px, :] = acc / wsum[..., None]

    return round_u8(out.reshape(img.shape[:-3] + (h * scale, w * scale, c)))


def _adaptive(img, scale, a, impl, device, batched, layout, weight_cache):
    if float(scale) != int(scale) or scale < 1:
        raise ValueError("adaptive_resize requires an integer upscale factor")
    if impl not in ("auto", "pallas", "jnp"):
        raise ValueError(f"unknown impl {impl!r}")
    if layout not in ("hwc", "auto"):
        raise ValueError(f"unknown layout {layout!r}")
    dev = resolve_device(device)
    with span("serve.upload"):
        img = torch.as_tensor(img).to(dev)
    with span("resize.dispatch"):
        if img.dtype != torch.uint8:
            raise ValueError("adaptive_resize expects uint8 input")
        if img.dim() != 3 + batched:
            raise ValueError(
                f"expected {'[B, H, W, C]' if batched else '[H, W, C]'} "
                f"uint8, got shape {tuple(img.shape)}")
        from .adaptive_fused import adaptive_resize_fused, fused_takes
        if impl == "auto":
            impl = ("pallas" if dev.type == "cuda"
                    and fused_takes(scale, img.shape[-1]) else "jnp")
        if impl == "pallas":
            words = (layout == "auto" and dev.type == "cuda" and not batched
                     and img.shape[-1] == 4)
            return adaptive_resize_fused(img, int(scale), float(a),
                                         layout="hwc32" if words else "hwc",
                                         weight_cache=weight_cache)
        return _adaptive_resize_u8(img, int(scale), float(a))


def adaptive_resize(img_u8, scale: int, a: float = -0.5, *,
                    impl: str = "auto", device="cuda", layout: str = "hwc",
                    weight_cache: dict | None = None):
    """Adaptive bicubic SR of an HWC uint8 image (numpy or tensor) at an
    integer scale; returns a tensor on ``device`` (the card by default:
    without one it raises unless given ``device="cpu"``).

    ``impl``: ``auto`` | ``pallas`` | ``jnp`` (see the module docstring).
    ``layout="hwc"`` returns uint8 [H*S, W*S, C]. ``layout="auto"`` is the
    serving layout: an RGBA frame that the kernel serves on the card comes
    back as RGBA32 words, uint32 [H*S, W*S], whose little-endian bytes are
    the HWC frame; every other frame as ``"hwc"``. ``weight_cache`` (a dict
    the caller owns) keeps the kernel's per-size device weight arrays
    across calls."""
    return _adaptive(img_u8, scale, a, impl, device, False, layout,
                     weight_cache)


def adaptive_resize_batch(imgs_u8, scale: int, a: float = -0.5, *,
                          impl: str = "auto", device="cuda",
                          weight_cache: dict | None = None):
    """:func:`adaptive_resize` over [B, H, W, C] same-size frames in one
    pass (the batch is the kernel's ``blockIdx.z``, and a tensor dimension
    of the plain graph); uint8 [B, H*S, W*S, C]."""
    return _adaptive(imgs_u8, scale, a, impl, device, True, "hwc",
                     weight_cache)


def adaptive_gt_factors(lr_float, scale: int, *, device="cuda"):
    """Per-tap adaptive factors of the data generator, upsampled to
    [H_sr, W_sr, 16].

    ``lr_float`` is the [H_lr, W_lr, C] float image in [0, 1] (C < 3 reads
    the last channel for the missing ones, as :func:`luma_bt709` does); the
    factors are a function of the LR base cell only (all S^2 HR phases of a
    cell share them), so they are computed at LR resolution and
    phase-repeated."""
    lr = torch.as_tensor(lr_float).to(resolve_device(device))
    h, w = lr.shape[:2]
    luma = luma_bt709(lr.to(torch.float32))
    lp = _edge_pad(luma, 1, 2, 1, 2, -2, -1)
    taps = torch.stack([lp[n:n + h, m:m + w]
                        for n in range(4) for m in range(4)])   # [16, H, W]
    contrast = taps.amax(dim=0) - taps.amin(dim=0)
    is_edge = contrast > 0.3
    is_flat = contrast < 0.1
    ld = (taps - luma[None]).abs()
    edge_f = 1.0 + 0.5 * (1.0 - ld / 0.3)
    flat_f = torch.clamp(1.0 - ld / 0.2, min=0.7)
    text_f = 0.8 + 0.4 * torch.exp(-ld / 0.15)
    f = torch.where(is_edge[None], edge_f,
                    torch.where(is_flat[None], flat_f, text_f))  # [16, H, W]
    f = f.movedim(0, -1)                                         # [H, W, 16]
    return f.repeat_interleave(scale, dim=0).repeat_interleave(scale, dim=1)
