"""The published ESRGAN generator's plain forward at 4x (RRDBNet).

Wang et al. 2018, "ESRGAN: Enhanced Super-Resolution Generative
Adversarial Networks" (arXiv:1809.00219); xinntao/ESRGAN
``RRDBNet_arch.py``, ``RRDBNet(3, 3, 64, 23, gc=32)`` (the
``RRDB_ESRGAN_x4.pth`` model), which is also Real-ESRGAN's
``RealESRGAN_x4plus`` (basicsr ``RRDBNet(num_in_ch=3, num_out_ch=3,
num_feat=64, num_block=23, num_grow_ch=32, scale=4)``):

  x = RGB / 255, NCHW; every conv 3x3, stride 1, zero padding 1, bias;
  lrelu slope 0.2
  RDB(x):  x_i = lrelu(conv_i(cat[x, x_1 .. x_{i-1}])), i = 1 .. 4
           return x + 0.2 * conv_5(cat[x, x_1 .. x_4])
  RRDB(x): return x + 0.2 * RDB_3(RDB_2(RDB_1(x)))
  fea = conv_first(x); fea = fea + conv_body(RRDB_23(... RRDB_1(fea)))
  fea = lrelu(conv_up1(nearest_2x(fea))); fea = lrelu(conv_up2(nearest_2x(
  fea)))
  out = conv_last(lrelu(conv_hr(fea)))
  uint8 = clip(out, 0, 1) * 255, rounded

in plain torch (``F.conv2d``, ``F.interpolate(mode="nearest")``,
``torch.cat``), in float64 as the oracle or in the ``"tf32"`` control.

Departures from the published code, each for a reason:

- The weights are not the trained ``RRDB_ESRGAN_x4.pth`` (not in this
  repository): they are drawn from the seed that the configuration's
  ``meta.json`` ``init`` states, by this file's own NumPy code, in the
  published parameter order, and ``conv_last``'s bias centres the output
  (``init["bias"]``), so that the bytes are not saturated.
- The output is rounded half up, ``floor(255 * y + 0.5)``, as the port's
  direct path rounds; the published scripts use ``torch.round`` (half to
  even). Both clip to [0, 255] first or after, which is the same.
- Only the first three channels of a frame are the input (an RGBA frame's
  alpha is dropped, as the port's direct path drops it).
"""

from __future__ import annotations

import json
import math
import pathlib

import numpy as np
import torch
import torch.nn.functional as F

from . import dtype_of, operand

#: what ``init`` has to state, word for word, for this reader to draw it
RNG = "numpy.random.default_rng(seed)"
ORDER = ("conv_first, body.<k>.rdb<j>.conv<i> for k = 0 .. n_blocks - 1, "
         "j = 1 .. 3, i = 1 .. 5, conv_body, conv_up1, conv_up2, conv_hr, "
         "conv_last")
KERNEL = ("float32(rng.standard_normal((out, in, 3, 3)) * (scale * "
          "sqrt(2 / (9 * in))))")
TOP = ("conv_body", "conv_up1", "conv_up2", "conv_hr")


def convs(n_blocks, nf, gc, channels=3):
    """``[(name, out, in)]`` in the published parameter order."""
    out = [("conv_first", nf, channels)]
    for k in range(n_blocks):
        for j in (1, 2, 3):
            for i in (1, 2, 3, 4, 5):
                out.append((f"body.{k}.rdb{j}.conv{i}",
                            gc if i < 5 else nf, nf + (i - 1) * gc))
    out += [(name, nf, nf) for name in TOP]
    out.append(("conv_last", channels, nf))
    return out


def draw(init, n_blocks, nf, gc):
    """``{name: (weight OIHW, bias)}`` float32 numpy, drawn as ``init``
    states."""
    if (init.get("rng"), init.get("order"), init.get("kernel")) != (
            RNG, ORDER, KERNEL):
        raise ValueError("init states a draw this reference does not make")
    rng = np.random.default_rng(int(init["seed"]))
    out = {}
    for name, n_out, n_in in convs(n_blocks, nf, gc):
        scale = init["scale"]["body" if name.startswith("body.") else name]
        std = scale * math.sqrt(2.0 / (9 * n_in))
        w = (rng.standard_normal((n_out, n_in, 3, 3)) * std).astype(
            np.float32)
        b = np.asarray(init.get("bias", {}).get(name, np.zeros(n_out)),
                       dtype=np.float32)
        out[name] = (w, b)
    return out


def load(ckpt_dir, device) -> dict:
    """The seeded weights that ``<ckpt_dir>/meta.json`` states, as float64
    tensors on ``device``, and the widths."""
    meta = json.loads((pathlib.Path(ckpt_dir) / "meta.json").read_text())
    n_blocks = int(meta.get("n_blocks", 23))
    nf, gc = int(meta.get("features", 64)), int(meta.get("growth", 32))
    weights = {name: (torch.tensor(w, dtype=torch.float64, device=device),
                      torch.tensor(b, dtype=torch.float64, device=device))
               for name, (w, b) in draw(meta["init"], n_blocks, nf,
                                        gc).items()}
    return {"weights": weights, "n_blocks": n_blocks}


def _conv(x, wb, precision):
    w, b = wb
    return F.conv2d(operand(x, precision),
                    operand(w.to(x.dtype), precision), b.to(x.dtype),
                    padding=1)


def _lrelu(x):
    return F.leaky_relu(x, 0.2)


def _rdb(x, wt, prefix, precision):
    feats = [x]
    for i in (1, 2, 3, 4):
        feats.append(_lrelu(_conv(torch.cat(feats, 1), wt[f"{prefix}.conv{i}"],
                                  precision)))
    return x + 0.2 * _conv(torch.cat(feats, 1), wt[f"{prefix}.conv5"],
                           precision)


def forward(state, x, precision):
    """The generator on NCHW ``x`` in [0, 1], before clipping."""
    wt = state["weights"]
    fea = _conv(x, wt["conv_first"], precision)
    body = fea
    for k in range(state["n_blocks"]):
        h = body
        for j in (1, 2, 3):
            h = _rdb(h, wt, f"body.{k}.rdb{j}", precision)
        body = body + 0.2 * h
    fea = fea + _conv(body, wt["conv_body"], precision)
    for name in ("conv_up1", "conv_up2"):
        fea = _lrelu(_conv(F.interpolate(fea, scale_factor=2,
                                         mode="nearest"), wt[name],
                           precision))
    return _conv(_lrelu(_conv(fea, wt["conv_hr"], precision)),
                 wt["conv_last"], precision)


@torch.no_grad()
def upscale_float(state, img_u8, precision="float64"):
    """[4H, 4W, 3] floats in [0, 1] units, before clipping and rounding, of
    one uint8 [H, W, C >= 3] frame."""
    x = img_u8[..., :3].permute(2, 0, 1)[None].to(dtype_of(precision)) \
        / 255.0
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        return forward(state, x, precision)[0].permute(1, 2, 0)


def run(state, img_u8, precision="float64"):
    """uint8 [4H, 4W, 3] of one uint8 [H, W, C >= 3] frame."""
    y = upscale_float(state, img_u8, precision)
    return torch.floor(y.clamp(0, 1) * 255.0 + 0.5).to(torch.uint8)


def prepare(config: dict, device):
    """The reference's state for a configuration: the weights its
    checkpoint directory's ``meta.json`` states (``checkpoint``, relative
    to the checkout)."""
    root = pathlib.Path(__file__).resolve().parents[2]
    return load(root / config["checkpoint"], device)
