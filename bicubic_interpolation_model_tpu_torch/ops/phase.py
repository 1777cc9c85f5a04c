"""Phase-FMA separable resize at integer scales (CUDA kernel D).

Counterpart of ``bicubic_interpolation_model_tpu/ops/pallas_phase.py``; the
kernel is ``csrc/resize_phase.cu``. For an integer scale S the plan of each
axis is scattered into window *slots* ``t = idx - (base - left)`` per input
row/column and output phase, which folds every clamp (duplicate clamped taps
accumulate) and nearest's phase-dependent tap offset into the weights — the
input then needs only zero padding:

    tmp[r*S+q, j, ch]    = sum_t wrow[r, q, t] * in[r + t - left, j, ch]
    out[r*S+q, X*S+p, ch] = sum_m wcol[p, m, X] * tmp[r*S+q, X + m - left, ch]

uint8 in → JS-rounded uint8 out (``clip(trunc(v + 0.5), 0, 255)``); float in
→ float32 out, unrounded. ``layout="hwc"`` is the interleaved image,
``layout="planar"`` is ``[B, S, H*S, W*C]`` (column phase planar, rows
interleaved). The kernel takes its extents at run time, so outputs have the
exact extents (the JAX form pads them to its tile grid; the valid region is
the same). The kernel reads the same weights restaged in the order its
threads read them (:func:`_kernel_weights`).

:func:`resize_phase_probe` launches the kernel's probe instances (uint8
RGBA): the same grid, staging and stores with one stage cut or replaced,
for dividing the kernel's time between its stages (``bench/labs.py``).
``"rowonly"`` stores the row pass at each LR column's first tap (input
column ``X - left``) for every column phase, with no column pass;
``"null"`` stores each LR pixel over its S x S block, with no row or column
pass; ``"chw"`` is the full resize stored channel-planar ``[B, C, H*S,
W*S]``. Their plain versions are :func:`resize_phase_reference`'s
``probe=``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import plan as planlib
from ..runtime import build
from ..runtime.device import as_device_tensor

#: LR rows and columns of one tile of csrc/resize_phase.cu, and the phases
#: a thread takes in each pass (its TILE_R, TILE_X and PH; the kernel takes
#: tiles of TILE_R / 2 rows where TILE_R would not fit its shared memory)
_TILE_R, _TILE_X, _PH = 16, 32, 4

# Left extent of each kernel's tap window relative to floor(ox): bicubic
# taps start at floor(ox)-1, lanczos-a at floor(ox)-a+1, the rest at 0.
_LEFT_EXTENT = {"nearest": 0, "bilinear": 0, "bicubic": 1, "lanczos": 2}

#: probe instances of the kernel and their ids in csrc/resize_phase.cu
PROBES = {"rowonly": 1, "null": 2, "chw": 3}


# tap-slot count per (method, scale): set by the kernel's support, never by
# the image size (clamping only shrinks the slot range)
def _n_slots(method: str, s: int, lanczos_a: int) -> int:
    if method == "nearest":
        return 1 if s == 1 else 2
    if method == "bilinear":
        return 2
    if method == "bicubic":
        return 4
    if method == "lanczos":
        return 2 * lanczos_a
    raise ValueError(f"unknown method {method!r}")


def _phase_plan_arrays(method: str, h: int, w: int, s: int, a: float,
                       lanczos_a: int):
    """Host-side plan → (wrow [h, S*T], wcol [S*T, w], taps, left).

    ``wrow[r, q*T + t]`` weighs input row ``r + t - left`` for output row
    ``r*S + q``; ``wcol[p*T + m, X]`` weighs input column ``X + m - left``
    for output column ``X*S + p``, with the exact clamp semantics of the
    (h, w) image folded in."""
    kw = ({"a": a} if method == "bicubic"
          else {"a": lanczos_a} if method == "lanczos" else {})
    plan_y = planlib.plan_axis(method, h, float(s), **kw)
    plan_x = planlib.plan_axis(method, w, float(s), **kw)
    left = lanczos_a - 1 if method == "lanczos" else _LEFT_EXTENT[method]
    taps = _n_slots(method, s, lanczos_a)

    def build_axis(plan):
        base = np.arange(plan.n_out) // s
        slots = plan.idx.astype(np.int64) - (base[:, None] - left)
        assert slots.min() >= 0 and slots.max() < taps
        out = np.zeros((plan.n_in, s, taps), np.float32)
        o = np.arange(plan.n_out)
        for k in range(plan.idx.shape[1]):
            np.add.at(out, (o // s, o % s, slots[:, k]), plan.w[:, k])
        return out

    wrow = build_axis(plan_y)
    wcol = build_axis(plan_x)
    return (wrow.reshape(wrow.shape[0], s * taps),
            np.ascontiguousarray(
                wcol.transpose(1, 2, 0).reshape(s * taps, wcol.shape[0])),
            taps, left)


def _interleave_wrow(wrow_np, s, taps):
    """[rows, S*T] per-input-row weights → [rows*S, T] interleaved layout
    (row r*S+q of the output reads window slots with wrow[r, q*T+t])."""
    rows = wrow_np.shape[0]
    return wrow_np.reshape(rows, s, taps).reshape(rows * s, taps)


def _kernel_weights(wrow_np, wcol_np, s, taps):
    """The plan arrays restaged for the kernel, zero past the image and
    past phase S: rows ``[ceil(H/16)*16, G, T, 4]`` with
    ``[r, g, t, i] = wrow[r, (4g+i)*T + t]``; columns
    ``[ceil(W/32), G, T, 32, 4]`` with
    ``[tx, g, m, x, i] = wcol[(4g+i)*T + m, 32*tx + x]``; G = ceil(S/4)
    phase groups."""
    h, w = wrow_np.shape[0], wcol_np.shape[1]
    g = -(-s // _PH)
    rows = np.zeros((-(-h // _TILE_R) * _TILE_R, g * _PH, taps), np.float32)
    rows[:h, :s] = wrow_np.reshape(h, s, taps)
    rows = rows.reshape(-1, g, _PH, taps).transpose(0, 1, 3, 2)
    n_tx = -(-w // _TILE_X)
    cols = np.zeros((g * _PH, taps, n_tx * _TILE_X), np.float32)
    cols[:s, :, :w] = wcol_np.reshape(s, taps, w)
    cols = cols.reshape(g, _PH, taps, n_tx, _TILE_X).transpose(3, 0, 2, 4, 1)
    return np.ascontiguousarray(rows), np.ascontiguousarray(cols)


def _shifted(x, t, axis, n):
    """``x`` shifted so index i along ``axis`` reads ``x[i + t]``, zero
    outside ``[0, n)``."""
    out = torch.zeros_like(x)
    lo, hi = max(0, -t), min(n, n - t)
    if hi > lo:
        dst = [slice(None)] * x.dim()
        src = [slice(None)] * x.dim()
        dst[axis] = slice(lo, hi)
        src[axis] = slice(lo + t, hi + t)
        out[tuple(dst)] = x[tuple(src)]
    return out


def resize_phase_reference(img_bhwc: torch.Tensor, wrow: torch.Tensor,
                           wcol: torch.Tensor, s: int, taps: int, left: int,
                           layout: str = "hwc",
                           dtype: torch.dtype = torch.float32,
                           probe: str = "full"):
    """The plain PyTorch version of the kernel: shifted slices times the
    slot weights, multiply-add over the slots in order, in ``dtype``
    (``torch.float64`` is the oracle on the card); the same rounding and
    layouts. ``wrow`` [H*S, T] (interleaved), ``wcol`` [S*T, W].

    ``probe`` (uint8 input) gives a probe instance's plain version:
    ``"rowonly"`` the row pass at input column ``X - left`` (zero outside),
    rounded, for every column phase; ``"null"`` each LR pixel over its
    S x S block; ``"chw"`` the result with its channels moved to the front,
    ``[B, C, H*S, W*S]`` (``layout`` is then not read)."""
    b, h, w, c = img_bhwc.shape
    out_u8 = img_bhwc.dtype == torch.uint8
    if probe not in ("full", *PROBES):
        raise ValueError(f"unknown probe {probe!r}")
    if probe == "chw":
        hwc = resize_phase_reference(img_bhwc, wrow, wcol, s, taps, left,
                                     dtype=dtype)
        return hwc.permute(0, 3, 1, 2).contiguous()
    x = img_bhwc.to(dtype)
    wr = wrow.to(dtype).reshape(h, s, taps)
    wc = wcol.to(dtype).reshape(s, taps, w)
    if probe == "null":
        out = x.repeat_interleave(s, 1)[:, None].expand(b, s, h * s, w, c)
    else:
        tmp = None                                  # [B, H, S, W, C]
        for t in range(taps):
            term = (wr[None, :, :, t, None, None]
                    * _shifted(x, t - left, 1, h)[:, :, None])
            tmp = term if tmp is None else tmp + term
        tmp = tmp.reshape(b, h * s, w, c)
    if probe == "rowonly":
        out = _shifted(tmp, -left, 2, w)[:, None].expand(b, s, h * s, w, c)
    elif probe == "full":
        out = None                                  # [B, S, H*S, W, C]
        for m in range(taps):
            term = (wc[None, :, m, None, :, None]
                    * _shifted(tmp, m - left, 2, w)[:, None])
            out = term if out is None else out + term
    if out_u8:
        out = torch.clamp(torch.trunc(out + 0.5), 0, 255).to(torch.uint8)
    else:
        out = out.to(torch.float32)
    if layout == "planar":
        return out.reshape(b, s, h * s, w * c)
    return out.permute(0, 2, 3, 1, 4).reshape(b, h * s, w * s, c)


def _phase_call(img_bhwc, weights, *, s, layout="hwc", probe="full"):
    """Dispatch on the tensor's device: CUDA launches the kernel on the
    restaged weights (or raises), CPU runs the plain version. ``weights``
    as :func:`_weights` gives them. ``probe`` other than ``"full"`` takes a
    probe instance (uint8 RGBA; :func:`resize_phase_probe`)."""
    wrow, wcol, taps, left, wrow_k, wcol_k = weights
    if layout not in ("hwc", "planar"):
        raise ValueError(f"unknown layout {layout!r}")
    b, h, w, c = img_bhwc.shape
    in_dtype = img_bhwc.dtype
    if probe != "full":
        if probe not in PROBES:
            raise ValueError(f"unknown probe {probe!r}")
        if in_dtype != torch.uint8 or c != 4 or (probe == "chw"
                                                 and layout != "hwc"):
            raise ValueError(f"probe {probe!r} takes uint8 RGBA frames"
                             + (" and layout='hwc'" if probe == "chw"
                                else ""))
    if in_dtype != torch.uint8:
        img_bhwc = img_bhwc.to(torch.float32)
    if not 1 <= c <= 4:
        raise ValueError(f"resize_phase takes 1 <= C <= 4 channels, got {c}")
    dev = img_bhwc.device
    if dev.type == "cpu":
        out = resize_phase_reference(img_bhwc, wrow, wcol, s, taps, left,
                                     layout, probe=probe)
        return out if in_dtype == torch.uint8 else out.to(in_dtype)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if b > 65535:
        raise ValueError(f"resize_phase takes at most 65535 frames, got {b}")
    out_u8 = img_bhwc.dtype == torch.uint8
    img_bhwc = img_bhwc.contiguous()
    shape = ((b, c, h * s, w * s) if probe == "chw"
             else (b, s, h * s, w * c) if layout == "planar"
             else (b, h * s, w * s, c))
    out = torch.empty(shape, dtype=torch.uint8 if out_u8 else torch.float32,
                      device=dev)
    if out.numel():
        lib = build.library()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            if probe == "full":
                rc = lib.bim_resize_phase(
                    img_bhwc.data_ptr(), int(out_u8), wrow_k.data_ptr(),
                    wcol_k.data_ptr(), out.data_ptr(), b, h, w, c, s, taps,
                    left, int(layout == "planar"), stream)
            else:
                rc = lib.bim_resize_phase_probe(
                    img_bhwc.data_ptr(), wrow_k.data_ptr(), wcol_k.data_ptr(),
                    out.data_ptr(), b, h, w, c, s, taps, left,
                    int(layout == "planar"), PROBES[probe], stream)
        if rc == -1:
            raise ValueError(f"resize_phase: scale {s} with {taps} taps "
                             "needs more shared memory than a block has")
        build.check(rc, "resize_phase" if probe == "full"
                    else f"resize_phase probe {probe}")
        if probe == "full":
            resize_phase.launches += 1
        else:
            resize_phase_probe.launches[
                probe + ("_planar" if layout == "planar" else "")] += 1
    return out if out_u8 else out.to(in_dtype)


def _weights(method, h, w, s, a, lanczos_a, device, weight_cache):
    """Device-resident (wrow [h*S, T], wcol [S*T, w], taps, left, and the
    kernel's restaged wrow and wcol from :func:`_kernel_weights`), cached
    per (h, w, s, method, a, lanczos_a, device) in the caller's dict; the
    first four are the plain version's arguments."""
    key = (h, w, s, method, float(a), int(lanczos_a), str(device))
    cached = weight_cache.get(key) if weight_cache is not None else None
    if cached is None:
        wrow_np, wcol_np, taps, left = _phase_plan_arrays(
            method, h, w, s, float(a), int(lanczos_a))
        cached = (torch.from_numpy(
            _interleave_wrow(wrow_np, s, taps)).to(device),
            torch.from_numpy(wcol_np).to(device), taps, left,
            *(torch.from_numpy(arr).to(device)
              for arr in _kernel_weights(wrow_np, wcol_np, s, taps)))
        if weight_cache is not None:
            weight_cache[key] = cached
    return cached


def _as_bhwc(img, device):
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
    return img, squeeze_b, squeeze_hw


def resize_phase(img, scale, method: str = "bicubic", *, a: float = -0.5,
                 lanczos_a: int = 3, layout: str = "hwc",
                 weight_cache: dict | None = None, device=None):
    """Fused phase-FMA resize. HW / HWC / BHWC uint8 or float input,
    integer scale. A tensor runs where it lies: a CUDA tensor launches the
    kernel (or raises), a CPU tensor runs :func:`resize_phase_reference`. A
    numpy frame is moved to ``device``, the card by default: without a card
    that raises unless ``device="cpu"``. A batch rides ``blockIdx.z``: one
    launch for the whole batch.

    ``layout="planar"`` (BHWC input only) returns ``[B, S, H*S, W*C]``; see
    :func:`interleave_planar`. ``weight_cache`` (a dict the caller owns)
    keeps per-size device weight arrays across calls."""
    if not (float(scale) == int(scale) and scale >= 1):
        raise ValueError("resize_phase requires an integer upscale")
    s = int(scale)
    img, squeeze_b, squeeze_hw = _as_bhwc(img, device)
    if layout == "planar" and (squeeze_b or squeeze_hw):
        raise ValueError("layout='planar' requires BHWC input")
    h, w = img.shape[1:3]
    weights = _weights(method, h, w, s, a, lanczos_a, img.device,
                       weight_cache)
    out = _phase_call(img, weights, s=s, layout=layout)
    if squeeze_b:
        out = out[0]
    return out[..., 0] if squeeze_hw else out


resize_phase.launches = 0


def resize_phase_probe(img, scale, probe: str, method: str = "bicubic", *,
                       a: float = -0.5, lanczos_a: int = 3,
                       layout: str = "hwc", weight_cache: dict | None = None,
                       device=None):
    """A probe instance of the kernel (``"rowonly"``, ``"null"`` or
    ``"chw"``; see the module docstring) on a uint8 RGBA BHWC frame at an
    integer scale: a CUDA tensor launches it, a CPU tensor runs its plain
    version (:func:`resize_phase_reference` ``probe=``), a numpy frame is
    moved to ``device``. ``layout`` as :func:`resize_phase` for
    ``"rowonly"`` and ``"null"``; ``"chw"`` returns ``[B, C, H*S, W*S]``.
    Launches are counted per instance in ``resize_phase_probe.launches``
    (the probe, ``_planar`` for the planar layout)."""
    if not (float(scale) == int(scale) and scale >= 1):
        raise ValueError("resize_phase_probe requires an integer upscale")
    s = int(scale)
    img = as_device_tensor(img, device)
    if img.dim() != 4:
        raise ValueError("resize_phase_probe takes BHWC frames, got shape "
                         f"{tuple(img.shape)}")
    h, w = img.shape[1:3]
    weights = _weights(method, h, w, s, a, lanczos_a, img.device,
                       weight_cache)
    return _phase_call(img, weights, s=s, layout=layout, probe=probe)


resize_phase_probe.launches = dict.fromkeys(
    ("rowonly", "rowonly_planar", "null", "null_planar", "chw"), 0)


def interleave_planar(planar, h: int, w: int, scale: int, c: int):
    """[B, S, rows, cols*C] planar output → [B, H*S, W*S, C]; tensors or
    fetched numpy arrays (rows ≥ H*S, cols ≥ W: padded extents slice off)."""
    s = int(scale)
    o = planar[:, :, :h * s, :w * c].reshape(-1, s, h * s, w, c)
    if isinstance(planar, np.ndarray):
        return np.transpose(o, (0, 2, 3, 1, 4)).reshape(-1, h * s, w * s, c)
    return o.permute(0, 2, 3, 1, 4).reshape(-1, h * s, w * s, c)
