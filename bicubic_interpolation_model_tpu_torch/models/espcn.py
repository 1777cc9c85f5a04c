"""ESPCN-class SR baselines (counterpart of
``bicubic_interpolation_model_tpu/models/espcn.py``, whose ``MODEL_ZOO``
is :mod:`.zoo` here).

ESPCN (sub-pixel conv, Shi et al. 2016) in the two sizes that fill the
reference's medium/thick slots. Every model here is a stack
of SAME convs on NHWC frames in [0, 1] with a pixel-shuffle output; its
parameters keep the flax tree of the JAX package (``Conv_0 .. Conv_N``).
"""

from __future__ import annotations

import torch

from .layers import Conv, TreeModule, conv, numbered, pixel_shuffle, \
    tree_from_jax, upsample_nearest


class ESPCN(TreeModule):
    """conv5x5 -> conv3x3 -> conv3x3(C*s^2) -> depth-to-space."""

    def __init__(self, scale: int = 4, channels: int = 3, features: int = 64,
                 *, generator=None):
        super().__init__()
        self.scale, self.channels, self.features = scale, channels, features
        g = dict(generator=generator)
        self.Conv_0 = Conv(5, 5, channels, features, **g)
        self.Conv_1 = Conv(3, 3, features, features // 2, **g)
        self.Conv_2 = Conv(3, 3, features // 2, channels * scale * scale, **g)

    def apply(self, params, x):
        p = params.get("params", params)
        h = torch.relu(conv(x, p["Conv_0"]))
        h = torch.relu(conv(h, p["Conv_1"]))
        return pixel_shuffle(conv(h, p["Conv_2"]), self.scale)


class ESPCNResidual(TreeModule):
    """'Thick' variant: a residual body (``n_blocks`` pairs of convs,
    scaled 0.1) and a global skip of the nearest-upsampled input."""

    def __init__(self, scale: int = 4, channels: int = 3, features: int = 64,
                 n_blocks: int = 6, *, generator=None):
        super().__init__()
        self.scale, self.channels = scale, channels
        self.features, self.n_blocks = features, n_blocks
        g = dict(generator=generator)
        f = features
        convs = [Conv(3, 3, channels, f, **g)]
        convs += [Conv(3, 3, f, f, **g) for _ in range(2 * n_blocks + 1)]
        convs.append(Conv(3, 3, f, channels * scale * scale, **g))
        for i, c in enumerate(convs):
            self.add_module(f"Conv_{i}", c)

    def apply(self, params, x):
        p = params.get("params", params)
        s = self.scale
        h = torch.relu(conv(x, p["Conv_0"]))
        skip = h
        for k in range(self.n_blocks):
            r = torch.relu(conv(h, p[f"Conv_{2 * k + 1}"]))
            r = conv(r, p[f"Conv_{2 * k + 2}"])
            h = h + 0.1 * r
        n = 2 * self.n_blocks
        h = conv(h, p[f"Conv_{n + 1}"]) + skip
        h = conv(h, p[f"Conv_{n + 2}"])
        return pixel_shuffle(h, s) + upsample_nearest(
            x[..., :self.channels], s)


def params_from_jax(tree: dict, *, device="cuda") -> dict:
    """A flax ESPCN / ESPCNResidual tree (numpy leaves) → the port's
    ``{"params": {"Conv_i": {"kernel", "bias"}}}`` of float32 tensors on
    ``device``."""
    out = tree_from_jax(tree, device=device)
    p = out["params"]
    names = numbered(p, "Conv")
    if not names or set(names) != set(p):
        raise ValueError(f"not an ESPCN tree: {sorted(p)}")
    return out
