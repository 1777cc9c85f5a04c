"""The learned 4x model's plain forward, at SR resolution.

The WeightPredictor of bloom-lmh/Bicubic-Interpolation-Model version3.0
(``model_super_resolution.js`` and its training notes): a fully
convolutional net that predicts 16 bicubic-style weights per HR pixel from
the LR frame and each HR pixel's subpixel offset, then applies them to the
pixel's 4x4 LR neighbourhood.

  img [C=4, H, W] / 255 -- conv_in 3x3, 32, relu -- conv_res 3x3, 32,
  + residual -- upsample (stride-S transposed conv, kernel S, 16 out) --
  x * sigmoid(conv_att 1x1, 1) --+
  offsets [2, H*S, W*S] -- conv_off 1x1, 16 ------------------+-- concat
  -- conv_out 3x3, 16 -- tanh -> w [16, H*S, W*S]
  out[c, y, x] = sum_i w[i, y, x] * lr[c, clamp(y // S - 1 + i // 4),
                                           clamp(x // S - 1 + i % 4)]
  rounded half to even, clipped to [0, 255].

Convs are SAME with zero padding; kernels are flax's HWIO and the
upsample's [S, S, out, in], read from the checkpoint file by
:mod:`.checkpoint`. Offsets, "train" convention: ``d = frac((x + 0.5) /
S) - 0.5``, channel 0 along columns (dx), channel 1 along rows (dy). This
runs the published equations as written, at SR resolution: no phase
packing, no fused tail.
"""

from __future__ import annotations

import pathlib

import torch
import torch.nn.functional as F

from . import dtype_of, operand
from .checkpoint import load_params

LAYERS = ("conv_in", "conv_res", "upsample", "conv_att", "conv_off",
          "conv_out")


def load(ckpt_dir, device) -> dict:
    """The checkpoint's six layers as float64 tensors on ``device``."""
    p = load_params(ckpt_dir)
    missing = [k for k in LAYERS if k not in p]
    if missing:
        raise ValueError(f"not a WeightPredictor checkpoint: no {missing}")
    return {k: {n: torch.tensor(p[k][n], dtype=torch.float64, device=device)
                for n in ("kernel", "bias")} for k in LAYERS}


def _conv(x, leaf, precision):
    """SAME stride-1 conv of NCHW ``x`` with an HWIO kernel."""
    k = leaf["kernel"].to(x.dtype)
    pad = k.shape[0] // 2
    return F.conv2d(operand(x, precision),
                    operand(k.permute(3, 2, 0, 1).contiguous(), precision),
                    leaf["bias"].to(x.dtype), padding=pad)


def _upsample(y, leaf, precision):
    """out[o, S*Y + a, S*X + b] = sum_i K[a, b, o, i] y[i, Y, X] + bias."""
    k = leaf["kernel"].to(y.dtype)
    s = k.shape[0]
    up = torch.einsum("nihw,abOi->nOhawb", operand(y, precision),
                      operand(k.contiguous(), precision))
    n, o, h, _, w, _ = up.shape
    return (up.reshape(n, o, h * s, w * s)
            + leaf["bias"].to(y.dtype)[None, :, None, None])


def offsets(h_sr, w_sr, scale, dtype, device):
    """[1, 2, h_sr, w_sr]: (dx, dy) = frac((i + 0.5) / S) - 0.5."""
    def axis(n):
        t = (torch.arange(n, dtype=torch.float64, device=device) + 0.5) \
            / scale
        return (t - torch.floor(t) - 0.5).to(dtype)
    dx, dy = axis(w_sr), axis(h_sr)
    return torch.stack([dx[None, :].expand(h_sr, w_sr),
                        dy[:, None].expand(h_sr, w_sr)])[None]


def weights(params, lr_u8, scale, precision):
    """[16, H*S, W*S] predicted weights of one [H, W, 4] uint8 frame."""
    dt = dtype_of(precision)
    x = lr_u8.permute(2, 0, 1)[None].to(dt) / 255.0
    h, w = x.shape[-2:]
    y = torch.relu(_conv(x, params["conv_in"], precision))
    y = y + _conv(y, params["conv_res"], precision)
    up = _upsample(y, params["upsample"], precision)
    gated = up * torch.sigmoid(_conv(up, params["conv_att"], precision))
    del up
    off = _conv(offsets(h * scale, w * scale, scale, dt, x.device),
                params["conv_off"], precision)
    merged = torch.cat([gated, off], dim=1)
    del gated, off
    return torch.tanh(_conv(merged, params["conv_out"], precision))[0]


def apply(lr_u8, wts, scale, dtype):
    """The 16-tap apply with clamped taps, before rounding: [H*S, W*S, C]."""
    h, w, c = lr_u8.shape
    lr = lr_u8.permute(2, 0, 1).to(dtype)
    dev = lr.device
    base_y = torch.arange(h * scale, device=dev) // scale - 1
    base_x = torch.arange(w * scale, device=dev) // scale - 1
    acc = None
    for ty in range(4):
        rows = lr[:, (base_y + ty).clamp(0, h - 1)]
        for tx in range(4):
            tap = rows[:, :, (base_x + tx).clamp(0, w - 1)]
            term = wts[4 * ty + tx].to(dtype) * tap
            acc = term if acc is None else acc + term
    return acc.permute(1, 2, 0)


@torch.no_grad()
def upscale(params, lr_u8, scale=4, precision="float64"):
    """uint8 [H*S, W*S, C] of one uint8 [H, W, 4] frame."""
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        wts = weights(params, lr_u8, scale, precision)
    out = apply(lr_u8, wts, scale, dtype_of(precision))
    return torch.round(out).clamp(0, 255).to(torch.uint8)


def prepare(config: dict, device):
    """The reference's state for a configuration: its checkpoint's layers,
    read from the raw file (``checkpoint``, relative to the checkout)."""
    root = pathlib.Path(__file__).resolve().parents[2]
    return {"params": load(root / config["checkpoint"], device),
            "scale": int(config["scale"])}


def run(state, lr_u8, precision="float64"):
    return upscale(state["params"], lr_u8, state["scale"], precision)
