"""Fused adaptive bicubic at integer scales (CUDA kernel E).

Counterpart of ``bicubic_interpolation_model_tpu/ops/pallas_adaptive.py``;
the kernel is ``csrc/adaptive.cu``. The whole computation of
:mod:`.adaptive` (BT.709 luma, 5x5 variance classes, the three modulation
laws, the positional centre exemption, the 16-tap normalised sum, the
rounding) runs in one launch per batch of same-size frames.

The Keys weights come from the host in float64 as data, per axis
(:func:`row_vectors`, :func:`col_vectors`): ``wy[r, q*4+n]`` is the weight of
tap ``n`` for LR row ``r`` and output phase ``q``, evaluated at the clamped
tap position, and ``wye = wy * eqy`` is the same weight where the clamped
tap row equals the clamped centre row, else 0 (the columns alike). With
``A = wy*wx``, ``E = wye*wxe`` and the modulation factor ``F`` of the tap,

    weight = E + (A - E) * F

is ``A`` exactly where the tap sits on the centre (the exemption, clamped
duplicates at the borders included) and ``A * F`` elsewhere.

Layouts: ``"hwc"`` uint8 [.., H*S, W*S, C]; ``"hwc32"`` (C = 4) the same
bytes viewed as RGBA32 words, uint32 [.., H*S, W*S]; ``"planar"`` uint32
[.., S, H*S, W], word ``(px, r, X)`` holding the C channels of output pixel
``(r, X*S + px)`` as little-endian bytes and 0 in the bytes above C (exact
extents; the JAX form pads them to its tile grid, the valid region is the
same). C is 1 to 4, as in the JAX kernel: a pixel packs into one word.

:func:`adaptive_probe` launches the kernel's probe instances (C = 1 or 4,
one pass): the same grid, windows, classes, staging and stores with the
law replaced or the exemption dropped, for dividing the kernel's time
between its stages (``bench/labs.py``). In the kernel's factored form a
tap's weight is ``A * F + E * (1 - F(0))``, ``F(0)`` the law at the centre
(1.2 for texture centres, 1 otherwise); the probes change ``F`` or drop
the second term (``PROBES``). Their plain versions are
:func:`adaptive_resize_reference`'s ``probe=``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..runtime import build
from ..runtime.device import as_device_tensor
from .adaptive import (EDGE, FLAT, TEXTURE, _cubic_memo_np, _edge_pad,
                       centre_offset, luma_bt709, region_classes)


#: probe instances of the kernel and their ids in csrc/adaptive.cu:
#: law_scratch F = 1 from the tap lumas in shared memory (one FMA each),
#: law_const F = 1, fma_only F = 1 and no exemption term, nolaw F =
#: (centre luma + 1024) - tap luma (one subtract), noeq the law without the
#: exemption term
PROBES = {"law_scratch": 1, "law_const": 2, "fma_only": 3, "nolaw": 4,
          "noeq": 5}
#: 1 - F(0) of a texture centre in f32, as csrc/adaptive.cu's
#: TEXTURE_CENTRE
_TEXTURE_CENTRE = float(np.float32(1.0) - (np.float32(0.8) + np.float32(0.4)))


def fused_takes(scale, c: int) -> bool:
    """True if :func:`adaptive_resize_fused` takes (scale, channels): an
    integer scale >= 1 and 1 to 4 channels (uint8 frames)."""
    return float(scale) == int(scale) and scale >= 1 and c in (1, 2, 3, 4)


def _axis_vectors(n_in: int, scale: int, a: float):
    """Per-axis host arrays (float64 → float32), exact border semantics.

    Returns (w [n_in, S, 4], eq [n_in, S, 4]) where w[b, q, n] is the Keys
    weight evaluated at the CLAMPED tap position for base cell b, phase q,
    tap n, and eq[b, q, n] is 1.0 where that clamped tap position equals
    the clamped centre position (the modulation exemption)."""
    base = np.arange(n_in, dtype=np.float64)
    w = np.zeros((n_in, scale, 4), np.float32)
    eq = np.zeros((n_in, scale, 4), np.float32)
    for p in range(scale):
        f = p / scale
        ox = base + f
        cen = np.clip(base + int(f >= 0.5), 0, n_in - 1)
        for n in range(4):
            pos = np.clip(base + n - 1, 0, n_in - 1)
            w[:, p, n] = _cubic_memo_np(ox - pos, a)
            eq[:, p, n] = (pos == cen).astype(np.float32)
    return w, eq


def row_vectors(h: int, s: int, a: float, pad_to: int):
    """Host row-weight arrays for rows 0..h: ([h_pad, S*4] wy,
    [h_pad, S*4] wy*eqy), column q*4+n. The border clamps of image height
    ``h`` are baked in; trailing pad rows are edge copies."""
    wy_np, eqy_np = _axis_vectors(h, s, a)

    def rowmajor(v):
        return np.pad(v.reshape(h, s * 4), ((0, pad_to - h), (0, 0)),
                      mode="edge")
    return rowmajor(wy_np), rowmajor(wy_np * eqy_np)


def col_vectors(w: int, s: int, a: float, pad_to: int):
    """Host column-weight array [2*S*4, w_pad]: wx, row px*4+m, stacked
    over the eq-folded wx*eqx."""
    wx_np, eqx_np = _axis_vectors(w, s, a)

    def colmajor(v):
        out = v.reshape(w, s * 4).T
        return np.pad(out, ((0, 0), (0, pad_to - w)), mode="edge")
    return np.concatenate([colmajor(wx_np), colmajor(wx_np * eqx_np)],
                          axis=0)


def _weights(h, w, s, a, device, weight_cache):
    """Device-resident (wy [h, 4S], wye [h, 4S], wx [8S, w]), cached per
    (h, w, s, a, device) in the caller's dict."""
    key = ("adaptive", h, w, s, float(a), str(device))
    cached = weight_cache.get(key) if weight_cache is not None else None
    if cached is None:
        wy, wye = row_vectors(h, s, a, h)
        dev = lambda arr: torch.from_numpy(np.ascontiguousarray(arr)).to(
            device)
        cached = (dev(wy), dev(wye), dev(col_vectors(w, s, a, w)))
        if weight_cache is not None:
            weight_cache[key] = cached
    return cached


def _words(u8_last4: torch.Tensor) -> torch.Tensor:
    """[..., 4] uint8 → [...] uint32 of the same bytes (little-endian)."""
    return u8_last4.contiguous().view(torch.uint32)[..., 0]


def adaptive_resize_reference(img_bhwc: torch.Tensor, wy: torch.Tensor,
                              wye: torch.Tensor, wx: torch.Tensor, s: int,
                              *, opaque_alpha: bool = False,
                              layout: str = "hwc",
                              dtype: torch.dtype = torch.float32,
                              probe: str = "full"):
    """The plain PyTorch version of the kernel, step by step on tensors in
    ``dtype`` (``torch.float64`` is the oracle on the card): luma and
    classes, the 16 factor maps of each centre variant, then per output
    phase the 16 weights ``E + (A - E) * F`` summed tap by tap (rows outer),
    ``clip(int(acc * (1/wsum) + 0.5), 0, 255)``; the same layouts.
    [B, H, W, C] uint8 with C in 1..4.

    ``probe`` gives a probe instance's plain version (module docstring):
    the weights ``A * F + E * g``, with ``F`` = 1 (``law_scratch``,
    ``law_const``, ``fma_only``), ``(centre luma + 1024) - tap luma``
    (``nolaw``) or the law (``noeq``), and ``g`` = 1 - F(0) of the class
    at texture centres and 0 elsewhere, or 0 everywhere (``fma_only``,
    ``noeq``)."""
    if probe not in ("full", *PROBES):
        raise ValueError(f"unknown probe {probe!r}")
    b, h, w, c = img_bhwc.shape
    opaque = opaque_alpha and c == 4
    nc = 3 if opaque else c
    x = img_bhwc.to(dtype)
    luma = luma_bt709(x)
    cls = region_classes(luma)
    lp = _edge_pad(luma, 1, 2, 1, 2, -2, -1)
    xp = _edge_pad(x[..., :nc], 1, 2, 1, 2, 1, 2)
    lp1 = _edge_pad(luma, 0, 1, 0, 1, -2, -1)
    cp1 = _edge_pad(cls, 0, 1, 0, 1, -2, -1)
    wyv = wy.to(dtype).reshape(h, s, 4)
    wyev = wye.to(dtype).reshape(h, s, 4)
    wxv = wx.to(dtype)[:4 * s].reshape(s, 4, w)
    wxev = wx.to(dtype)[4 * s:].reshape(s, 4, w)

    groups: dict = {}
    for p in range(s):
        groups.setdefault(centre_offset(p, s), []).append(p)
    out = torch.zeros((b, h, s, w, s, 4), dtype=torch.uint8,
                      device=img_bhwc.device)
    if opaque:
        out[..., 3] = 255
    for cy, qs in groups.items():
        for cx, pxs in groups.items():
            cl = lp1[:, cy:cy + h, cx:cx + w]
            k = cp1[:, cy:cy + h, cx:cx + w]
            f = [[None] * 4 for _ in range(4)]
            for n in range(4):
                for m in range(4):
                    if probe in ("full", "noeq"):
                        ld = (cl - lp[:, n:n + h, m:m + w]).abs()
                        edge_f = torch.clamp(1.0 + ld * 0.01, max=1.5)
                        flat_f = torch.clamp(1.0 - ld * (1.0 / 30.0),
                                             min=0.5)
                        text_f = 0.8 + 0.4 * torch.exp(ld * -0.05)
                        f[n][m] = torch.where(
                            k == EDGE, edge_f,
                            torch.where(k == FLAT, flat_f, text_f))
                    elif probe == "nolaw":
                        f[n][m] = (cl + 1024.0) - lp[:, n:n + h, m:m + w]
                    else:
                        f[n][m] = torch.ones_like(cl)
            # the exemption's coefficient of a probe: 1 - F(0) at texture
            # centres (the kernel's factored term), none for fma_only, noeq
            g = (torch.where(k == TEXTURE, _TEXTURE_CENTRE, 0.0).to(dtype)
                 if probe in ("law_scratch", "law_const", "nolaw")
                 else None)
            for q in qs:
                for px in pxs:
                    wsum = None
                    acc = None
                    for n in range(4):
                        for m in range(4):
                            a_ = wyv[:, q, n, None] * wxv[px, m][None, :]
                            e_ = wyev[:, q, n, None] * wxev[px, m][None, :]
                            if probe == "full":
                                wgt = e_ + (a_ - e_) * f[n][m]
                            elif g is None:
                                wgt = a_ * f[n][m]
                            else:
                                wgt = a_ * f[n][m] + e_ * g
                            t = wgt[..., None] * xp[:, n:n + h, m:m + w]
                            wsum = wgt if wsum is None else wsum + wgt
                            acc = t if acc is None else acc + t
                    v = acc * (1.0 / wsum)[..., None] + 0.5
                    out[:, :, q, :, px, :nc] = torch.clamp(
                        v.to(torch.int32), 0, 255).to(torch.uint8)
    if layout == "planar":
        return _words(out.permute(0, 4, 1, 2, 3, 5)).reshape(b, s, h * s, w)
    hwc = out.reshape(b, h * s, w * s, 4)
    if layout == "hwc32":
        return _words(hwc)
    return hwc[..., :c].contiguous()


def _launch(img, wy, wye, wx, s, layout, opaque, classes_out, stage,
            probe="full"):
    b, h, w, c = img.shape
    if b > 65535:
        raise ValueError(f"adaptive_resize_fused takes at most 65535 "
                         f"frames, got {b}")
    img = img.contiguous()
    if c == 4 and img.data_ptr() % 4:   # it reads an RGBA pixel as a word
        img = img.clone()
    planar = layout == "planar"
    if planar:
        out = torch.empty((b, s, h * s, w), dtype=torch.uint32,
                          device=img.device)
    else:
        out = torch.empty((b, h * s, w * s, c), dtype=torch.uint8,
                          device=img.device)
    if out.numel() and probe != "full":
        lib = build.library()
        with torch.cuda.device(img.device):
            rc = lib.bim_adaptive_probe(
                img.data_ptr(), wy.data_ptr(), wye.data_ptr(), wx.data_ptr(),
                out.data_ptr(), None, b, h, w, c, s, int(planar),
                PROBES[probe], torch.cuda.current_stream().cuda_stream)
        build.check(rc, f"adaptive_probe {probe}")
        adaptive_probe.launches[probe + ("_c1" if c == 1 else "")] += 1
    elif out.numel():
        lib = build.library()
        with torch.cuda.device(img.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc = lib.bim_adaptive_resize(
                img.data_ptr(), wy.data_ptr(), wye.data_ptr(), wx.data_ptr(),
                out.data_ptr(),
                None if classes_out is None else classes_out.data_ptr(),
                b, h, w, c, s, int(planar), int(opaque), int(stage), stream)
        build.check(rc, "adaptive_resize_fused")
        adaptive_resize_fused.launches += 1
    if layout == "hwc32":
        return _words(out)
    return out


def adaptive_resize_fused(img_u8, scale: int, a: float = -0.5, *,
                          layout: str = "hwc", opaque_alpha: bool = False,
                          weight_cache: dict | None = None, device=None,
                          classes_out: torch.Tensor | None = None,
                          stage_phases: int = 0):
    """Fused adaptive-bicubic SR of an HWC or BHWC uint8 image with 1 to 4
    channels at an integer scale. A tensor runs where it lies: a CUDA
    tensor launches the kernel (or raises), a CPU tensor runs
    :func:`adaptive_resize_reference`. A numpy frame is moved to ``device``,
    the card by default: without a card that raises unless
    ``device="cpu"``. A batch rides ``blockIdx.z``: one launch.

    ``opaque_alpha`` is an explicit promise that the alpha channel is a
    constant 255: the kernel then writes 255 and skips the channel's sums.
    ``layout``: see the module docstring. ``weight_cache`` (a dict the
    caller owns) keeps per-size device weight arrays across calls.
    ``classes_out`` (uint8 [B, H, W] on the image's device) receives each
    LR pixel's region class as this call computed it (0 texture, 1 flat,
    2 edge): for checks. ``stage_phases`` (0: all that fit) bounds how many
    of the S x S output phases of its tile the kernel stages in shared
    memory per pass, below what fits: scales above 14 take several passes,
    and this makes a small scale take them too, for checks."""
    if float(scale) != int(scale) or scale < 1:
        raise ValueError("the fused adaptive path requires an integer "
                         "upscale")
    if layout not in ("hwc", "hwc32", "planar"):
        raise ValueError(f"unknown layout {layout!r}")
    s = int(scale)
    img = as_device_tensor(img_u8, device)
    if img.dtype != torch.uint8 or img.dim() not in (3, 4):
        raise ValueError("adaptive_resize_fused expects HWC or BHWC uint8, "
                         f"got {img.dtype} {tuple(img.shape)}")
    squeeze_b = img.dim() == 3
    if squeeze_b:
        img = img[None]
    b, h, w, c = img.shape
    if not fused_takes(s, c):
        raise ValueError(f"adaptive_resize_fused takes 1 to 4 channels (a "
                         f"pixel packs into one 32-bit word), got {c}")
    if layout == "hwc32" and c != 4:
        raise ValueError("layout='hwc32' requires 4 channels")
    if classes_out is not None and (
            classes_out.dtype != torch.uint8 or classes_out.shape != (b, h, w)
            or classes_out.device != img.device
            or not classes_out.is_contiguous()):
        raise ValueError("classes_out must be a contiguous uint8 [B, H, W] "
                         "tensor on the image's device")
    wy, wye, wx = _weights(h, w, s, float(a), img.device, weight_cache)
    opaque = bool(opaque_alpha) and c == 4
    if img.device.type == "cpu":
        out = adaptive_resize_reference(img, wy, wye, wx, s,
                                        opaque_alpha=opaque, layout=layout)
        if classes_out is not None:
            classes_out.copy_(region_classes(luma_bt709(img.float())))
    elif img.device.type == "cuda":
        out = _launch(img, wy, wye, wx, s, layout, opaque, classes_out,
                      stage_phases)
    else:
        raise ValueError(f"unsupported device {img.device}")
    return out[0] if squeeze_b else out


adaptive_resize_fused.launches = 0


def adaptive_probe(img_u8, scale: int, probe: str, a: float = -0.5, *,
                   layout: str = "hwc", weight_cache: dict | None = None,
                   device=None):
    """A probe instance of the kernel (``PROBES``; module docstring) on an
    HWC or BHWC uint8 frame of 1 or 4 channels at an integer scale whose
    S x S tile fits one pass (S <= 14): a CUDA tensor launches it, a CPU
    tensor runs its plain version (:func:`adaptive_resize_reference`
    ``probe=``), a numpy frame is moved to ``device``. ``layout`` "hwc" or
    "planar". Launches are counted per instance in
    ``adaptive_probe.launches`` (the probe, ``_c1`` for one channel)."""
    if probe not in PROBES:
        raise ValueError(f"unknown probe {probe!r}")
    if float(scale) != int(scale) or not 1 <= scale <= 14:
        raise ValueError("adaptive_probe takes integer scales 1 to 14 (one "
                         "pass of the S x S tile)")
    if layout not in ("hwc", "planar"):
        raise ValueError(f"unknown layout {layout!r}")
    s = int(scale)
    img = as_device_tensor(img_u8, device)
    if img.dtype != torch.uint8 or img.dim() not in (3, 4):
        raise ValueError("adaptive_probe expects HWC or BHWC uint8, got "
                         f"{img.dtype} {tuple(img.shape)}")
    squeeze_b = img.dim() == 3
    if squeeze_b:
        img = img[None]
    b, h, w, c = img.shape
    if c not in (1, 4):
        raise ValueError(f"adaptive_probe takes 1 or 4 channels, got {c}")
    wy, wye, wx = _weights(h, w, s, float(a), img.device, weight_cache)
    if img.device.type == "cpu":
        out = adaptive_resize_reference(img, wy, wye, wx, s, layout=layout,
                                        probe=probe)
    elif img.device.type == "cuda":
        out = _launch(img, wy, wye, wx, s, layout, False, None, 0, probe)
    else:
        raise ValueError(f"unsupported device {img.device}")
    return out[0] if squeeze_b else out


adaptive_probe.launches = dict.fromkeys(
    [p + sfx for sfx in ("", "_c1") for p in PROBES], 0)


def adaptive_resize_fused_batch(imgs_u8, scale: int, a: float = -0.5, **kw):
    """[B, H, W, C] same-size frames in one launch (the per-frame geometry
    is identical, so the host-built weight vectors are shared)."""
    if getattr(imgs_u8, "ndim", 0) != 4:
        raise ValueError("expected [B, H, W, C] uint8")
    return adaptive_resize_fused(imgs_u8, scale, a, **kw)


def unpack_planar(packed_u32: torch.Tensor, h: int, w: int, scale: int,
                  c: int) -> torch.Tensor:
    """[.., S, R, X] channel-packed uint32 planar output (R >= H*S, X >= W:
    padded extents slice off) → [.., H*S, W*S, C] uint8."""
    s = int(scale)
    lead = packed_u32.shape[:-3]
    bytes_ = packed_u32.contiguous().view(torch.uint8).reshape(
        lead + packed_u32.shape[-3:] + (4,))
    o = bytes_[..., :h * s, :w, :].movedim(-4, -2)          # [.., hS, w, S, 4]
    return o[..., :c].reshape(lead + (h * s, w * s, c))
