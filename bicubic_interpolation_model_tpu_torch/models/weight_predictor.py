"""The weight-predictor model: a fully-convolutional net that maps an LR
image + HR-resolution subpixel-offset map to 16 bicubic weights per HR
pixel (counterpart of ``bicubic_interpolation_model_tpu/models/
weight_predictor.py``):

  img [B,H,W,4] ── Conv 32 3x3 relu ── Conv 32 3x3 ──(+residual)──
      PixelShuffleUpsample 16 ── x · sigmoid(Conv 1 1x1) ──┐
  off [B,4H,4W,2] ── Conv 16 1x1 ──────────────────────────┴─ concat ──
      Conv 16 3x3 ── tanh

Public I/O is NHWC and parameters keep flax's tree and layouts, so a
checkpoint of the JAX package loads by :func:`params_from_jax`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..runtime.device import resolve_device
from .layers import (Conv, PixelShuffleUpsample, TreeModule, conv_nhwc,
                     pixel_shuffle_upsample)

LAYERS = ("conv_in", "conv_res", "upsample", "conv_att", "conv_off",
          "conv_out")


def _gated_features(p: dict, img: torch.Tensor) -> torch.Tensor:
    """The LR trunk, the upsample and the attention gate: ``up * att``."""
    x = torch.relu(conv_nhwc(img, **p["conv_in"]))
    x = x + conv_nhwc(x, **p["conv_res"])
    up = pixel_shuffle_upsample(x, **p["upsample"])
    return up * torch.sigmoid(conv_nhwc(up, **p["conv_att"]))


def _offset_features(p: dict, offsets: torch.Tensor) -> torch.Tensor:
    return conv_nhwc(offsets, **p["conv_off"])


def _head(p: dict, merged: torch.Tensor) -> torch.Tensor:
    return torch.tanh(conv_nhwc(merged, **p["conv_out"]))


def _call(segment, *args):
    return segment(*args)


def forward_params(p: dict, img: torch.Tensor, offsets: torch.Tensor,
                   run=_call) -> torch.Tensor:
    """The forward on a flax-style ``{layer: {kernel, bias}}`` tree:
    [B,H,W,C] image (0..1) + [B,H*S,W*S,2] offsets → [B,H*S,W*S,16].

    It runs in three segments, each through ``run(segment, *args)``: the
    LR trunk with the upsample and the attention gate, ``conv_off``, and
    ``conv_out`` → tanh on their concatenation. The trainer's remat passes
    a ``torch.utils.checkpoint`` there, so that the backward re-creates
    one segment's SR-resolution tensors at a time. The concatenation lies
    between the segments: the head keeps it as its input, and the
    segments' outputs it was made of are freed, so the head's backward
    holds the 32 merged channels once, not beside their 16 + 16 sources."""
    gated = run(_gated_features, p, img)
    off = run(_offset_features, p, offsets)
    return run(_head, p, torch.cat([gated, off], dim=-1))


class WeightPredictor(TreeModule):
    """Its :meth:`tree` is ``{"params": {layer: {kernel, bias}}}`` of
    the module's own parameters (no copies)."""

    def __init__(self, features: int = 32, n_weights: int = 16,
                 scale: int = 4, *, generator=None):
        super().__init__()
        self.features, self.n_weights, self.scale = features, n_weights, scale
        g = dict(generator=generator)
        # RGBA input, the image shape the JAX package initialises with
        self.conv_in = Conv(3, 3, 4, features, **g)
        self.conv_res = Conv(3, 3, features, features, **g)
        self.upsample = PixelShuffleUpsample(n_weights, scale, features, **g)
        self.conv_att = Conv(1, 1, n_weights, 1, **g)
        self.conv_off = Conv(1, 1, 2, n_weights, **g)
        self.conv_out = Conv(3, 3, 2 * n_weights, n_weights, **g)

    @torch.no_grad()
    def load_tree(self, tree: dict) -> "WeightPredictor":
        """Copy a flax-style tree (numpy or torch leaves) into the module;
        leaves other than the six layers' are ignored."""
        return super().load_tree(params_from_jax(
            tree, device=self.conv_in.kernel.device))

    @staticmethod
    def apply(params, img, offsets, run=_call):
        """The forward on a ``{"params": ...}`` tree (or its inner dict);
        ``run`` as in :func:`forward_params`."""
        return forward_params(params.get("params", params), img, offsets,
                              run)

    def forward(self, img, offsets):
        return self.apply(self.tree(), img, offsets)


def params_from_jax(tree: dict, *, device="cuda") -> dict:
    """A flax WeightPredictor tree of numpy (or jax/torch) arrays → the
    port's ``{"params": {layer: {"kernel", "bias"}}}`` of float32 tensors
    on ``device``. Layouts are kept (conv kernels HWIO, upsample
    [S, S, out, in]); :func:`forward_params` convolves them as they are."""
    dev = resolve_device(device)
    p = tree.get("params", tree)
    missing = [k for k in LAYERS if k not in p]
    if missing:
        raise ValueError(f"not a WeightPredictor tree: missing {missing}")
    return {"params": {
        name: {k: torch.as_tensor(np.array(p[name][k], dtype=np.float32),
                                  device=dev)
               for k in ("kernel", "bias")}
        for name in LAYERS}}


def init_params(generator=None, scale: int = 4, h: int = 8, w: int = 8, *,
                device="cuda"):
    """``(model, params)`` with fresh weights drawn from ``generator`` (a
    ``torch.Generator`` on the CPU; ``h``/``w`` are kept for the JAX
    package's signature — PyTorch needs no example input to initialise)."""
    dev = resolve_device(device)
    del h, w
    model = WeightPredictor(scale=scale, generator=generator)
    model = model.to(dev)
    return model, model.tree()
