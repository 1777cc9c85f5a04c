"""Classical Keys bicubic, separable, as the reference repository's
``bicubic_super_resolution.js`` computes it (bloom-lmh/Bicubic-
Interpolation-Model version3.0, method 3; Keys 1981, a = -0.5).

For output index x along an axis of n input samples at scale S:
source position ox = x / S (corner aligned), taps at
clamp(floor(ox) - 1 + m, 0, n - 1) for m = 0..3, each weighted by the Keys
kernel at (ox - tap), evaluated at the clamped tap, the four normalised to
sum 1. The JS divides the 2-D sum by the 2-D weight sum; that sum is the
product of the per-axis sums, so two normalised passes are the same map.
Output extent round(n * S); values stored as JS ``Math.round`` into a
Uint8ClampedArray: clip(floor(v + 0.5), 0, 255).
"""

from __future__ import annotations

import math

import torch

from . import dtype_of, operand


def keys(t: torch.Tensor, a: float) -> torch.Tensor:
    t = t.abs()
    near = (a + 2.0) * t ** 3 - (a + 3.0) * t ** 2 + 1.0
    far = a * t ** 3 - 5.0 * a * t ** 2 + 8.0 * a * t - 4.0 * a
    return torch.where(t <= 1.0, near,
                       torch.where(t <= 2.0, far, torch.zeros_like(t)))


def axis_taps(n_in: int, scale: float, a: float, device):
    """(idx [n_out, 4] int64, w [n_out, 4] float64) of one axis."""
    n_out = int(math.floor(n_in * scale + 0.5))
    ox = torch.arange(n_out, dtype=torch.float64, device=device) / scale
    idx = (torch.floor(ox)[:, None] - 1
           + torch.arange(4, device=device)[None]).clamp(0, n_in - 1)
    w = keys(ox[:, None] - idx, a)
    return idx.long(), w / w.sum(dim=1, keepdim=True)


def _pass(x, idx, w, axis, precision):
    """out[i] = sum_k w[i, k] * x[idx[i, k]] along ``axis`` (0 or 1)."""
    w = operand(w.to(x.dtype), precision)
    x = operand(x, precision)
    acc = None
    for k in range(idx.shape[1]):
        g = x.index_select(axis, idx[:, k])
        wk = w[:, k].reshape((-1, 1, 1) if axis == 0 else (1, -1, 1))
        acc = wk * g if acc is None else acc + wk * g
    return acc


@torch.no_grad()
def upscale(img_u8: torch.Tensor, scale: float = 4, a: float = -0.5,
            precision: str = "float64") -> torch.Tensor:
    """uint8 [round(H*S), round(W*S), C] of one uint8 [H, W, C] frame."""
    h, w = img_u8.shape[:2]
    iy, wy = axis_taps(h, scale, a, img_u8.device)
    ix, wx = axis_taps(w, scale, a, img_u8.device)
    x = img_u8.to(dtype_of(precision))
    x = _pass(x, iy, wy, 0, precision)
    x = _pass(x, ix, wx, 1, precision)
    return torch.floor(x + 0.5).clamp(0, 255).to(torch.uint8)


def prepare(config: dict, device):
    return {"scale": float(config["scale"]), "a": float(config["a"])}


def run(state, img_u8, precision="float64"):
    return upscale(img_u8, state["scale"], state["a"], precision)
