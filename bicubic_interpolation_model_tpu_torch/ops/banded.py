"""Banded-matrix separable resize at integer scales (CUDA kernel F).

Counterpart of ``bicubic_interpolation_model_tpu/ops/pallas_resize.py``; the
kernel is ``csrc/resize_banded.cu``. The exact per-axis plans have a few
taps, so the dense sampling matrix is banded: an output tile of ``TH`` rows
touches ``TH/scale + taps`` input rows. The matrices are pre-sliced on the
host into per-tile bands ``B_row [nI, TH, KH]`` / ``B_colT [nJ, KW, TW]``
and each (channel plane, row tile, column tile) is two small dense products
inside the kernel:

    out[c, i·TH:(i+1)·TH, j·TW:(j+1)·TW] =
        round_u8( B_row[i] @ window(img[c]) @ B_colT[j] )

The reference's clamp semantics are folded into the band weights (duplicate
clamped taps accumulate onto one input column), and the zero padding that
gives every tile a window of one size carries zero weight. uint8 in → uint8
out (``clip(floor(v + 0.5))``); float in → float out, unrounded. Integer
upscales only. The tile is the port's own: 8 x 32 LR pixels. The kernel
runs both products on the tensor cores and contracts, per 16-row slab of
``B_row`` and 16-column slab of ``B_colT``, only the 8-deep blocks of K that
hold a non-zero weight (:func:`_block_ranges`, computed beside the bands).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import plan as planlib
from ..runtime import build
from ..runtime.device import full_f32_matmul
from .phase import _LEFT_EXTENT, _as_bhwc
from .resize import round_u8

#: LR rows and columns of one output tile (csrc/resize_banded.cu takes any
#: tile whose output rows are a multiple of 8 and columns of 16, and band
#: windows whose K is a multiple of 8)
_STEP_H, _STEP_W = 8, 32
#: rows of B_row and columns of B_colT per block range (the M of the
#: kernel's m16n8k8 row product and of its transposed column product), and
#: the depth of a block (its k8)
_SLAB_ROW, _SLAB_COL, _KB = 16, 16, 8


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _banded(plan: planlib.AxisPlan, tile_out: int, k_pad: int,
            left: int) -> np.ndarray:
    """Slice the dense sampling matrix into per-tile bands.

    Band i covers output rows [i·tile_out, (i+1)·tile_out) and input rows
    [i·tile_out/scale - left, ...+k_pad) in *original* coordinates (reads
    before row 0 or past the image are zero). Output rows beyond n_out get
    zero weight."""
    scale = int(plan.scale)
    step = tile_out // scale
    n_tiles = _round_up(plan.n_out, tile_out) // tile_out
    bands = np.zeros((n_tiles, tile_out, k_pad), dtype=np.float32)
    for i in range(n_tiles):
        start = i * step - left  # original coords of window begin
        for r in range(tile_out):
            o = i * tile_out + r
            if o >= plan.n_out:
                break
            k = plan.idx[o].astype(np.int64) - start
            assert k.min() >= 0 and k.max() < k_pad, "band window too small"
            np.add.at(bands[i, r], k, plan.w[o])
    return bands


def _block_ranges(bands: np.ndarray, slab: int) -> np.ndarray:
    """Per band and per slab of ``slab`` rows of ``bands`` [n, rows, K],
    the first 8-deep block of K that holds a non-zero weight and one past
    the last, as int32 [n, ceil(rows / slab), 2]; (0, 0) for a slab with
    none. The kernel contracts only these blocks: the others add exact
    zeros."""
    n, rows, k = bands.shape
    n_sl = -(-rows // slab)
    nz = np.zeros((n, n_sl * slab, k), bool)
    nz[:, :rows] = bands != 0
    blocks = nz.reshape(n, n_sl, slab, k // _KB, _KB).any(axis=(2, 4))
    any_ = blocks.any(axis=-1)
    lo = np.where(any_, blocks.argmax(axis=-1), 0)
    hi = np.where(any_, blocks.shape[-1] - blocks[..., ::-1].argmax(axis=-1),
                  0)
    return np.stack([lo, hi], axis=-1).astype(np.int32)


def _bands(method, h, w, s, a, lanczos_a, device, weight_cache):
    """Device-resident (B_row [nI, TH, KH], B_colT [nJ, KW, TW], left,
    the block ranges of B_row's 16-row slabs [nI, ceil(TH/16), 2] and of
    B_colT's 16-column slabs [nJ, TW/16, 2], the longest column range), cached
    per (h, w, s, method, a, lanczos_a, device) in the caller's dict; the
    first three are the plain version's arguments."""
    key = ("banded", h, w, s, method, float(a), int(lanczos_a), str(device))
    cached = weight_cache.get(key) if weight_cache is not None else None
    if cached is None:
        kw = ({"a": a} if method == "bicubic"
              else {"a": lanczos_a} if method == "lanczos" else {})
        plan_y = planlib.plan_axis(method, h, float(s), **kw)
        plan_x = planlib.plan_axis(method, w, float(s), **kw)
        left = lanczos_a - 1 if method == "lanczos" else _LEFT_EXTENT[method]
        k_h = _round_up(_STEP_H + plan_y.taps, _KB)
        k_w = _round_up(_STEP_W + plan_x.taps, _KB)
        b_row = _banded(plan_y, _STEP_H * s, k_h, left)
        b_col = _banded(plan_x, _STEP_W * s, k_w, left)
        k_row = _block_ranges(b_row, _SLAB_ROW)
        k_col = _block_ranges(b_col, _SLAB_COL)
        cached = (torch.from_numpy(b_row).to(device),
                  torch.from_numpy(np.ascontiguousarray(
                      b_col.transpose(0, 2, 1))).to(device), left,
                  torch.from_numpy(k_row).to(device),
                  torch.from_numpy(k_col).to(device),
                  max(1, int((k_col[..., 1] - k_col[..., 0]).max())))
        if weight_cache is not None:
            weight_cache[key] = cached
    return cached


def resize_banded_reference(img_bhwc: torch.Tensor, b_row: torch.Tensor,
                            b_colt: torch.Tensor, s: int, left: int,
                            dtype: torch.dtype = torch.float32):
    """The plain PyTorch version of the kernel, step by step on tensors in
    ``dtype`` (``torch.float64`` is the oracle on the card): zero-pad, cut
    every tile's window, ``B_row[i] @ window @ B_colT[j]`` per channel plane
    and tile, crop, round. [B, H, W, C] → [B, H*s, W*s, C]."""
    b, h, w, c = img_bhwc.shape
    n_i, th, k_h = b_row.shape
    n_j, k_w, tw = b_colt.shape
    step_h, step_w = th // s, tw // s
    out_u8 = img_bhwc.dtype == torch.uint8
    xp = torch.zeros((b, c, (n_i - 1) * step_h + k_h,
                      (n_j - 1) * step_w + k_w), dtype=dtype,
                     device=img_bhwc.device)
    xp[:, :, left:left + h, left:left + w] = img_bhwc.permute(0, 3, 1, 2)
    with full_f32_matmul():
        win = xp.unfold(2, k_h, step_h)             # [B, C, nI, Wp, KH]
        tmp = torch.einsum("itk,bciwk->bcitw", b_row.to(dtype), win)
        win = tmp.unfold(4, k_w, step_w)            # [B, C, nI, TH, nJ, KW]
        out = torch.einsum("bcitjk,jkx->bcitjx", win, b_colt.to(dtype))
    out = out.reshape(b, c, n_i * th, n_j * tw)[:, :, :h * s, :w * s]
    out = out.permute(0, 2, 3, 1)
    if out_u8:
        return round_u8(out).contiguous()
    return out.to(torch.float32).contiguous()


def _launch(img, b_row, b_colt, s, left, k_row, k_col, kbc):
    b, h, w, c = img.shape
    if b > 65535:
        raise ValueError(f"resize_banded takes at most 65535 frames, got {b}")
    out_u8 = img.dtype == torch.uint8
    img = img.contiguous()
    n_i, th, k_h = b_row.shape
    n_j, k_w, tw = b_colt.shape
    out = torch.empty((b, h * s, w * s, c), device=img.device,
                      dtype=torch.uint8 if out_u8 else torch.float32)
    if out.numel():
        lib = build.library()
        with torch.cuda.device(img.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc = lib.bim_resize_banded(
                img.data_ptr(), int(out_u8), b_row.data_ptr(),
                b_colt.data_ptr(), k_row.data_ptr(), k_col.data_ptr(),
                out.data_ptr(), b, h, w, c, h * s, w * s, n_i, n_j, th, tw,
                k_h, k_w, s, left, kbc, stream)
        if rc == -1:
            raise ValueError(
                f"resize_banded: scale {s} with a {k_h}x{k_w} window per "
                "tile needs more shared memory than a block has")
        build.check(rc, "resize_banded")
        resize_banded.launches += 1
    return out


def resize_banded(img, scale, method: str = "bicubic", *, a: float = -0.5,
                  lanczos_a: int = 3, weight_cache: dict | None = None,
                  device=None):
    """Banded-matrix resize. HW / HWC / BHWC uint8 or float input, integer
    scale, any channel count. A tensor runs where it lies: a CUDA tensor
    launches the kernel (or raises), a CPU tensor runs
    :func:`resize_banded_reference`. A numpy frame is moved to ``device``,
    the card by default: without a card that raises unless
    ``device="cpu"``. A batch rides ``blockIdx.z``: one launch.
    ``weight_cache`` (a dict the caller owns) keeps per-size device bands
    across calls."""
    if not (float(scale) == int(scale) and scale >= 1):
        raise ValueError("resize_banded requires an integer upscale factor")
    if method not in ("bicubic", "bilinear", "nearest", "lanczos"):
        raise ValueError(f"unknown method {method!r}")
    s = int(scale)
    img, squeeze_b, squeeze_hw = _as_bhwc(img, device)
    in_dtype = img.dtype
    if in_dtype != torch.uint8:
        img = img.to(torch.float32)
    h, w = img.shape[1:3]
    bands = _bands(method, h, w, s, float(a), int(lanczos_a), img.device,
                   weight_cache)
    if img.device.type == "cpu":
        out = resize_banded_reference(img, *bands[:2], s, bands[2])
    elif img.device.type == "cuda":
        out = _launch(img, *bands[:2], s, *bands[2:])
    else:
        raise ValueError(f"unsupported device {img.device}")
    if in_dtype != torch.uint8:
        out = out.to(in_dtype)
    if squeeze_b:
        out = out[0]
    return out[..., 0] if squeeze_hw else out


resize_banded.launches = 0
