"""Ops of the learned-weights pipeline: subpixel offset maps, ground-truth
Keys-weight maps and the 16-tap apply-weights resampling op.

Counterpart of ``bicubic_interpolation_model_tpu/ops/learned.py``. Weight
channel ``i`` of an output pixel maps to LR neighbour ``(dy, dx) = (i // 4,
i % 4)`` from base ``(floor(y/s) - 1, floor(x/s) - 1)`` with clamped
indices. For integer scales the apply runs phase-planar: the LR image is
edge-padded by (1, 2) per axis (the same as clamping) and each of the S*S
output phase planes is one 16-term FMA chain at LR resolution.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..runtime.device import resolve_device


def cubic_keys_jnp(t, a: float = -0.5):
    """Keys cubic kernel (the JAX package's name, kept for the reader)."""
    t = t.abs()
    w1 = (a + 2.0) * t**3 - (a + 3.0) * t**2 + 1.0
    w2 = a * t**3 - 5.0 * a * t**2 + 8.0 * a * t - 4.0 * a
    return torch.where(t <= 1.0, w1, torch.where(t <= 2.0, w2,
                                                 torch.zeros_like(t)))


def _axis_offsets(n_sr: int, scale: float, convention: str, device=None):
    x = torch.arange(n_sr, dtype=torch.float32, device=device)
    if convention == "train":
        # dx = frac((x+0.5)/s) - 0.5  in [-0.5, 0.5)
        xl = (x + 0.5) / scale
        return xl - torch.floor(xl) - 0.5
    if convention == "inference":
        # dx = x/s - (floor(x/s) + 0.5)
        xl = x / scale
        return xl - (torch.floor(xl) + 0.5)
    raise ValueError(f"unknown offset convention {convention!r}")


def offset_map(h_sr: int, w_sr: int, scale: float,
               convention: str = "train", *, device="cuda") -> torch.Tensor:
    """[H_sr, W_sr, 2] float32 map of (dx, dy) subpixel offsets."""
    dev = resolve_device(device)
    dx = _axis_offsets(w_sr, scale, convention, dev)
    dy = _axis_offsets(h_sr, scale, convention, dev)
    return torch.stack([dx[None, :].expand(h_sr, w_sr),
                        dy[:, None].expand(h_sr, w_sr)], dim=-1)


def gt_weights_from_offsets(dx, dy, a: float = -0.5) -> torch.Tensor:
    """16 normalized Keys weights per pixel from (dx, dy) offsets.

    Tap arguments per axis are (1+d, d, 1-d, 2-d); the 4x4 grid is flattened
    y-tap-major (i = 4*ytap + xtap). Zeros if the weight sum <= 1e-6.
    """
    def taps(d):
        return torch.stack([cubic_keys_jnp(1.0 + d, a), cubic_keys_jnp(d, a),
                            cubic_keys_jnp(1.0 - d, a),
                            cubic_keys_jnp(2.0 - d, a)], dim=-1)
    grid = taps(dy)[..., :, None] * taps(dx)[..., None, :]
    w = grid.reshape(grid.shape[:-2] + (16,))
    s = w.sum(dim=-1, keepdim=True)
    return torch.where(s > 1e-6, w / s, torch.zeros_like(w))


def gt_weight_map(h_sr: int, w_sr: int, scale: float,
                  convention: str = "train", a: float = -0.5, *,
                  device="cuda") -> torch.Tensor:
    """[H_sr, W_sr, 16] ground-truth weight map."""
    off = offset_map(h_sr, w_sr, scale, convention, device=device)
    return gt_weights_from_offsets(off[..., 0], off[..., 1], a=a)


def _edge_pad_chw(lr: torch.Tensor) -> torch.Tensor:
    """[..., H, W, C] → planar [..., C, H+3, W+3], edge-padded (1 leading,
    2 trailing) — the clamp of the 4x4 tap reach."""
    lead = lr.shape[:-3]
    x = lr.movedim(-1, -3).reshape((-1,) + lr.shape[-1:] + lr.shape[-3:-1])
    x = F.pad(x, (1, 2, 1, 2), mode="replicate")
    return x.reshape(lead + x.shape[1:])


def _apply_weights_phase(lr: torch.Tensor, weights: torch.Tensor,
                         scale: int) -> torch.Tensor:
    """Phase-planar apply: one 16-term FMA chain per (row-phase, col-phase)
    plane at LR resolution, channels planar."""
    h_lr, w_lr, c = lr.shape
    h_sr, w_sr, _ = weights.shape
    s = int(scale)
    chw = _edge_pad_chw(lr)                              # [C, Hl+3, Wl+3]
    wr = weights.reshape(h_lr, s, w_lr, s, 16)
    cols = []
    for ay in range(s):
        planes = []
        for qx in range(s):
            acc = None
            for i in range(16):
                dy, dx = i // 4, i % 4
                t = wr[:, ay, :, qx, i][None] * chw[:, dy:dy + h_lr,
                                                    dx:dx + w_lr]
                acc = t if acc is None else acc + t
            planes.append(acc)                           # [C, Hl, Wl]
        cols.append(torch.stack(planes, dim=-1))         # [C, Hl, Wl, S]
    grid = torch.stack(cols, dim=2)                      # [C, Hl, S, Wl, S]
    return grid.permute(1, 2, 3, 4, 0).reshape(h_sr, w_sr, c)


def _apply_weights_gather(lr: torch.Tensor,
                          weights: torch.Tensor) -> torch.Tensor:
    h_lr, w_lr, _ = lr.shape
    h_sr, w_sr, _ = weights.shape
    dev = lr.device
    y_base = torch.floor(torch.arange(h_sr, device=dev) / (h_sr / h_lr)
                         ).to(torch.int64) - 1
    x_base = torch.floor(torch.arange(w_sr, device=dev) / (w_sr / w_lr)
                         ).to(torch.int64) - 1
    out = torch.zeros((h_sr, w_sr, lr.shape[2]), dtype=torch.float32,
                      device=dev)
    for r in range(4):
        rows = lr[(y_base + r).clamp(0, h_lr - 1)]
        for cx in range(4):
            tap = rows[:, (x_base + cx).clamp(0, w_lr - 1)]
            out = out + tap * weights[..., 4 * r + cx:4 * r + cx + 1]
    return out


def _apply_round(out: torch.Tensor) -> torch.Tensor:
    # torch.round is round-half-to-even, matching the learned path's
    # tf.round (model_super_resolution.js:121); the classical paths round
    # half up instead. Clip after rounding.
    return torch.round(out).clamp(0, 255).to(torch.int32)


def apply_weights(lr_img, weights, *, rounded: bool = True):
    """Apply a [H_sr, W_sr, 16] weight map to an LR image (values 0..255),
    on the weights' device. ``rounded`` returns int32 like the reference's
    clipByValue(0,255).round().cast('int32'), else float32."""
    weights = torch.as_tensor(weights)
    lr = torch.as_tensor(lr_img).to(weights.device, torch.float32)
    h_lr, w_lr = lr.shape[:2]
    h_sr, w_sr = weights.shape[:2]
    if h_sr % h_lr == 0 and w_sr % w_lr == 0 and h_sr // h_lr == w_sr // w_lr:
        out = _apply_weights_phase(lr, weights, h_sr // h_lr)
    else:
        out = _apply_weights_gather(lr, weights)
    return _apply_round(out) if rounded else out
