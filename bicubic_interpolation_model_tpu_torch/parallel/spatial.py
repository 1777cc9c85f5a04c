"""Band-sharded SR of one frame over the devices of a mesh axis (counterpart
of ``bicubic_interpolation_model_tpu/parallel/spatial.py``).

Band i of n holds LR rows [i*hb, (i+1)*hb) of an H-row frame (hb = H / n)
on the axis's i-th device. Where the JAX package exchanges halo rows with
``jax.lax.ppermute``, a band here copies the real neighbour rows it needs
from the frame (``.to(device)``: peer to peer across cards, a slice on one
card); rows beyond the true border are what ``ppermute`` gives an edge
shard, zeros. Each band runs the single-frame kernel of its family:

- learned (:func:`learned_resize_spatial_sharded`): convs and the merged
  map per band, then kernel G (:func:`..ops.packed_tail.packed_tail`,
  ``halo="rows"``);
- classical (:func:`resize_spatial_sharded`): kernel C per band on its
  slice of the global row plan (``impl="mxu"``), or two f32 matmuls per
  band against banded row matrices (``impl="einsum"``);
- adaptive (:func:`adaptive_resize_spatial_sharded`): kernel E per band.

Band outputs are written into one output on the axis's first device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import plan as planlib
from ..models.inference import packed_merged_map, param_tree
from ..models.layers import conv_nhwc
from ..models.zoo import is_weight_predictor
from ..ops import mxu
from ..ops.adaptive_fused import adaptive_resize_fused
from ..ops.packed_tail import (packed_tail, packed_tail_reference,
                               packed_tail_supported)
from ..ops.planar import unpack_planar
from ..runtime.device import conv_precision, full_f32_matmul
from .mesh import Mesh


def _band_window(x: torch.Tensor, lo: int, hi: int, dev) -> torch.Tensor:
    """Rows [lo, hi) of ``x`` on ``dev``; rows outside the frame are zero
    (what ``ppermute`` hands the edge shards)."""
    a, b = max(lo, 0), min(hi, x.shape[0])
    win = x[a:b].to(dev, non_blocking=True)
    if a == lo and b == hi:
        return win
    z = lambda k: torch.zeros((k,) + tuple(x.shape[1:]), dtype=x.dtype,
                              device=dev)
    return torch.cat([z(a - lo), win, z(hi - b)])


def _gather(bands, devs, shape, dtype) -> torch.Tensor:
    """Band outputs (row blocks in order) written into one tensor on the
    first device."""
    out = torch.empty(shape, dtype=dtype, device=devs[0])
    r = 0
    for band in bands:
        out[r:r + band.shape[0]].copy_(band, non_blocking=True)
        r += band.shape[0]
    return out


def _frame_and_bands(img, mesh, axis, min_rows=1):
    devs = mesh.axis_devices(axis)
    x = torch.as_tensor(img)
    n = len(devs)
    if x.shape[0] % n:
        raise ValueError(f"H={x.shape[0]} not divisible by {n} shards")
    if x.shape[0] // n < min_rows:
        raise ValueError(f"bands must be at least {min_rows} rows tall")
    return x, devs, x.shape[0] // n


def _plan_kw(method, a, lanczos_a):
    return ({"a": a} if method == "bicubic"
            else {"a": lanczos_a} if method == "lanczos" else {})


def _plan_halo(plan: planlib.AxisPlan, n_shards: int) -> int:
    """LR rows a band can reach outside its own slab, derived from the
    plan's tap indices (2 for 4-tap kernels, 3 for lanczos-3, 0 for
    nearest)."""
    step = plan.n_in // n_shards
    out_step = plan.n_out // n_shards
    band = np.arange(plan.n_out) // out_step
    lo = int((band * step - plan.idx.min(axis=1)).max())
    hi = int((plan.idx.max(axis=1) - ((band + 1) * step - 1)).max())
    return max(lo, hi, 0)


def _row_bands(plan: planlib.AxisPlan, n_shards: int,
               halo: int) -> np.ndarray:
    """Per-shard row sampling matrices [n, out_step, step + 2*halo] against
    the local window [i*step - halo, (i+1)*step + halo)."""
    h_in, h_out = plan.n_in, plan.n_out
    if h_in % n_shards or h_out % n_shards:
        raise ValueError(
            f"H_in={h_in}/H_out={h_out} not divisible by {n_shards} shards")
    step = h_in // n_shards
    out_step = h_out // n_shards
    bands = np.zeros((n_shards, out_step, step + 2 * halo), dtype=np.float32)
    for i in range(n_shards):
        start = i * step - halo
        for r in range(out_step):
            o = i * out_step + r
            np.add.at(bands[i, r], plan.idx[o].astype(np.int64) - start,
                      plan.w[o])
    return bands


def _resize_spatial(x, s, method, a, lanczos_a, devs, hb):
    """Two f32 matmuls per band (TF32 off) against its banded row matrix
    and the column matrix; u8 rounds as ``floor(x + 0.5)``, clipped."""
    h, w, c = x.shape
    kw = _plan_kw(method, a, lanczos_a)
    plan_y = planlib.plan_axis(method, h, float(s), **kw)
    m_col_t = np.ascontiguousarray(planlib.plan_to_matrix(
        planlib.plan_axis(method, w, float(s), **kw)).T)
    halo = _plan_halo(plan_y, len(devs))
    bands = _row_bands(plan_y, len(devs), halo)
    outs = []
    for i, dev in enumerate(devs):
        win = _band_window(x, i * hb - halo, (i + 1) * hb + halo, dev)
        band = torch.from_numpy(bands[i]).to(dev)
        col = torch.from_numpy(m_col_t).to(dev)
        with full_f32_matmul():
            tmp = band @ win.float().reshape(win.shape[0], w * c)
            o = (tmp.reshape(-1, w, c).transpose(1, 2) @ col).transpose(1, 2)
        if x.dtype == torch.uint8:
            o = torch.clamp(torch.floor(o + 0.5), 0, 255).to(torch.uint8)
        outs.append(o.to(x.dtype))
    return _gather(outs, devs, (h * s, m_col_t.shape[1], c), x.dtype)


def _resize_spatial_mxu(x, s, method, a, lanczos_a, devs, hb):
    """Kernel C per band (its plain version on a CPU device). Band i takes
    rows ``sl`` of the GLOBAL row plan (true-border clamps folded into its
    weights), indexed from the first real row its taps read, and the real
    rows [lo, hi) they reach: the same weights at the same taps as the
    single-frame kernel, which sums each output's taps in input order
    whatever band group the output falls in, so the bytes are the same."""
    h, w, c = x.shape
    kw = _plan_kw(method, a, lanczos_a)
    plan_y = planlib.plan_axis(method, h, float(s), **kw)
    plan_x = planlib.plan_axis(method, w, float(s), **kw)
    cols = mxu._axis_operands(plan_x.idx, plan_x.w, mxu._TILE_X)
    out_step = plan_y.n_out // len(devs)
    xf = x if x.dtype == torch.uint8 else x.to(torch.float32)
    col_ops: dict = {}
    outs = []
    for i, dev in enumerate(devs):
        sl = slice(i * out_step, (i + 1) * out_step)
        lo, hi = int(plan_y.idx[sl].min()), int(plan_y.idx[sl].max()) + 1
        iy = plan_y.idx[sl] - np.int32(lo)
        on = lambda arr: torch.from_numpy(np.ascontiguousarray(arr)).to(dev)
        if dev not in col_ops:
            col_ops[dev] = (on(plan_x.idx), on(plan_x.w), on(cols[0]),
                            on(cols[1]), on(cols[2]))
        ix, wx, band_x, lo_x, col_lo = col_ops[dev]
        win = xf[lo:hi].to(dev, non_blocking=True)[None]
        if dev.type == "cuda":
            band_y, lo_y, row_lo, win_r = mxu._axis_operands(
                iy, plan_y.w[sl], mxu._TILE_R)
            o = mxu._launch(win, on(band_y), on(lo_y), on(row_lo), band_x,
                            lo_x, col_lo, win_r, cols[3], out_step,
                            plan_x.n_out)
        elif dev.type == "cpu":
            o = mxu.resize_mxu_reference(win, on(iy), on(plan_y.w[sl]), ix, wx)
        else:
            raise ValueError(f"unsupported device {dev}")
        outs.append(o[0].to(x.dtype))
    return _gather(outs, devs, (h * s, plan_x.n_out, c), x.dtype)


def resize_spatial_sharded(img, scale, method: str = "bicubic", *,
                           mesh: Mesh, axis: str = "spatial",
                           a: float = -0.5, lanczos_a: int = 3,
                           impl: str = "auto"):
    """Resize one HWC image (numpy or tensor) with its rows sharded over
    ``mesh[axis]``: integer scale, H divisible by the axis size. Returns
    the image on the axis's first device.

    ``impl``: "mxu" runs kernel C per band (byte-equal to the single-frame
    ``resize_mxu``); "einsum" two f32 matmuls per band against banded row
    matrices, whose halo is the method's tap reach (0 nearest, 1 bilinear,
    2 bicubic, ``lanczos_a`` lanczos); "auto" takes "mxu" on a CUDA mesh
    for what kernel C takes (``ops/mxu.mxu_takes``), else "einsum"."""
    if float(scale) != int(scale) or scale < 1:
        raise ValueError("spatial sharding requires an integer upscale")
    if impl not in ("auto", "mxu", "einsum"):
        raise ValueError(f"impl must be 'auto', 'mxu' or 'einsum', got "
                         f"{impl!r}")
    x, devs, hb = _frame_and_bands(img, mesh, axis)
    if x.dim() != 3:
        raise ValueError(f"expected an HWC image, got {tuple(x.shape)}")
    s = int(scale)
    if impl == "auto":
        impl = ("mxu" if devs[0].type == "cuda"
                and mxu.mxu_takes(s, x.shape[-1], method) else "einsum")
    if impl == "mxu":
        if not mxu.mxu_takes(s, x.shape[-1], method):
            raise ValueError(f"impl='mxu' takes 1 <= C <= 4 channels, got "
                             f"{x.shape[-1]}")
        return _resize_spatial_mxu(x, s, method, float(a), int(lanczos_a),
                                   devs, hb)
    return _resize_spatial(x, s, method, float(a), int(lanczos_a), devs, hb)


_ADAPTIVE_HALO_UP = 2     # tap/variance reach above the base row
_ADAPTIVE_HALO_DOWN = 3   # centre row can be b+1; variance reaches b+3


def adaptive_resize_spatial_sharded(img, scale, *, mesh: Mesh,
                                    axis: str = "spatial", a: float = -0.5,
                                    layout: str = "hwc"):
    """Adaptive-bicubic SR of one HWC uint8 frame (C = 1 to 4) with its LR
    rows band-sharded over ``mesh[axis]``: kernel E per band (its plain
    version on a CPU device).

    Band i runs on its rows plus the REAL rows around them that adaptive
    bicubic reads (2 above, 3 below: taps, centres and 5x5 variance
    windows), cut at the true image. Kernel E builds its row weights for
    the rows it is given, so a window edge clamps only where it is the true
    border, and every kept row sees what the single-frame kernel sees: the
    bytes are the same. (The JAX function instead pads every band to the
    same height with replicated rows and shards absolute row vectors;
    nothing here needs them.) Rows of the window beyond the band are
    dropped from its output.

    ``layout="hwc"`` returns uint8 [H*S, W*S, C]; ``"planar"`` the
    exact-extent planar uint32 [S, H*S, W] (the JAX form pads W)."""
    if float(scale) != int(scale) or scale < 1:
        raise ValueError("adaptive spatial sharding requires an integer "
                         "upscale")
    if layout not in ("hwc", "planar"):
        raise ValueError(f"layout must be 'hwc' or 'planar', got {layout!r}")
    x, devs, hb = _frame_and_bands(img, mesh, axis, _ADAPTIVE_HALO_DOWN)
    if x.dtype != torch.uint8 or x.dim() != 3 or x.shape[-1] > 4:
        raise ValueError("expected HWC uint8 with c <= 4")
    h, w, c = x.shape
    s = int(scale)
    outs = []
    for i, dev in enumerate(devs):
        lo = max(0, i * hb - _ADAPTIVE_HALO_UP)
        hi = min(h, (i + 1) * hb + _ADAPTIVE_HALO_DOWN)
        win = x[lo:hi].to(dev, non_blocking=True)
        r0 = (i * hb - lo) * s
        o = adaptive_resize_fused(win, s, a, layout=layout)
        outs.append(o[r0:r0 + hb * s] if layout == "hwc"
                    else o[:, r0:r0 + hb * s].movedim(1, 0))
    if layout == "hwc":
        return _gather(outs, devs, (h * s, w * s, c), torch.uint8)
    # planar bands are gathered row-major ([rows, S, W]), then moved back
    return _gather(outs, devs, (h * s, s, w), torch.uint32).movedim(
        0, 1).contiguous()


_LEARNED_HALO = 3   # conv_in(1) + conv_res(1) + conv_out(±1 LR row)


def _outside_zeroed(t, i, n, hh):
    """Rows outside the true image zeroed on the edge bands ([1, rows,
    ...]): the next conv's SAME padding must see zeros there, not values
    computed from the zero halo."""
    rows = t.shape[1]
    keep = torch.ones(rows, dtype=t.dtype, device=t.device)
    if i == 0:
        keep[:hh] = 0
    if i == n - 1:
        keep[rows - hh:] = 0
    return t * keep.reshape((1, rows) + (1,) * (t.ndim - 2))


def _learned_band(pd, xe, i, n, hb, s, convention, use_kernel):
    """One band of the packed learned forward (``_learned_spatial``'s body):
    ``xe`` is uint8 [hb+6, W, C], the band with 3 halo rows each side."""
    hh = _LEARNED_HALO
    with conv_precision(torch.float32), full_f32_matmul():
        xf = (xe.float() / 255.0)[None]
        y = _outside_zeroed(torch.relu(conv_nhwc(xf, **pd["conv_in"])),
                            i, n, hh)
        y = y + conv_nhwc(y, **pd["conv_res"])
        m = _outside_zeroed(packed_merged_map(pd, y, s, convention),
                            i, n, hh)
        # apply taps: LR rows [-1, hb+2), replicated at the true borders
        # (the single-frame apply clamps tap positions to the image)
        xa = xe[hh - 1:hh + hb + 2].float()
        if i == 0:
            xa[0] = xa[1]
        if i == n - 1:
            xa[-2:] = xa[-3]
        mb = m[0, hh - 1:hh + hb + 1]               # map rows [-1, hb+1)
        kout, bout = pd["conv_out"]["kernel"], pd["conv_out"]["bias"]
        if use_kernel:
            return packed_tail(mb, xa, kout, bout, scale=s, halo="rows")
        return unpack_planar(packed_tail_reference(
            mb, xa, kout, bout, scale=s, halo="rows"), hb, mb.shape[1], s,
            xa.shape[-1])


def learned_resize_spatial_sharded(model, params, img, scale=4, *,
                                   mesh: Mesh, axis: str = "spatial",
                                   convention: str = "train",
                                   tail: str = "auto"):
    """Learned weight-predictor SR of one HWC uint8 frame with its LR rows
    band-sharded over ``mesh[axis]``: the packed forward of
    ``models/inference._super_resolve_packed`` runs per band.

    A band takes 3 halo rows of pixels each side (conv_in, conv_res and the
    phase-decomposed conv_out reach ±3 LR rows); beyond the true borders
    they are zeros, the convs' SAME padding, and the 16-tap apply replaces
    them with the replicated rows its clamp needs. ``tail``: "kernel" runs
    kernel G per band (its plain version on a CPU device; raises on a shape
    it does not take), "graph" the plain tail chain, "auto" the kernel on a
    CUDA mesh where it takes the shape. The params are placed once on each
    distinct device of the axis. Matches the single-frame packed path to
    ≤1 u8 LSB with the same tail, ≤2 across tails. Returns uint8
    [H*S, W*S, C] on the axis's first device."""
    if not is_weight_predictor(model, params):
        raise ValueError("spatial sharding implemented for WeightPredictor "
                         "checkpoints")
    if tail not in ("auto", "kernel", "graph"):
        raise ValueError(f"tail must be 'auto', 'kernel' or 'graph', got "
                         f"{tail!r}")
    x, devs, hb = _frame_and_bands(img, mesh, axis, _LEARNED_HALO)
    n = len(devs)
    h, w, c = x.shape
    s = int(scale)
    p = param_tree(params)
    twof = 2 * p["upsample"]["kernel"].shape[2]
    supported = packed_tail_supported(s, twof, c)
    if tail == "kernel" and not supported:
        raise ValueError(f"tail='kernel' takes S*2F == 128 and c <= 4; got "
                         f"S={s}, 2F={twof}, c={c} (use tail='graph')")
    placed = {dev: {name: {k: v.to(dev) for k, v in leaves.items()}
                    for name, leaves in p.items()} for dev in set(devs)}
    outs = []
    for i, dev in enumerate(devs):
        xe = _band_window(x, i * hb - _LEARNED_HALO,
                          (i + 1) * hb + _LEARNED_HALO, dev)
        use_kernel = supported and (tail == "kernel" or (
            tail == "auto" and dev.type == "cuda"))
        outs.append(_learned_band(placed[dev], xe, i, n, hb, s, convention,
                                  use_kernel))
    return _gather(outs, devs, (h * s, w * s, c), torch.uint8)
