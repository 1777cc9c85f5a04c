"""ESRGAN-class SR model (RRDB generator, Wang et al. 2018), counterpart of
``bicubic_interpolation_model_tpu/models/esrgan.py``: Residual-in-Residual
Dense Blocks with 0.2 residual scaling, pixel-shuffle upsampling by steps
of 2 (or the whole odd remainder), two convs on the HR grid, and a global
skip of the nearest-upsampled input. Leaky ReLUs have slope 0.2.

flax tree: ``Conv_0`` (head), ``RRDB_k/DenseBlock_j/Conv_i``, ``Conv_1``
(body end), one ``Conv`` per upsampling step, then the HR conv and the
output conv.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import Conv, TreeModule, conv, numbered, pixel_shuffle, \
    tree_from_jax, upsample_nearest


def _leaky(x):
    return F.leaky_relu(x, 0.2)


def _steps(scale: int) -> list[int]:
    """The upsampling steps: 2 while the remainder is even, else all of it
    at once (scale 4 → [2, 2], 3 → [3], 6 → [2, 3])."""
    out, remaining = [], scale
    while remaining > 1:
        step = 2 if remaining % 2 == 0 else remaining
        out.append(step)
        remaining //= step
    return out


class DenseBlock(TreeModule):
    """5-conv dense block: each conv sees all previous features."""

    def __init__(self, features: int, growth: int, *, generator=None):
        super().__init__()
        g = dict(generator=generator)
        for i in range(4):
            self.add_module(f"Conv_{i}",
                            Conv(3, 3, features + i * growth, growth, **g))
        self.Conv_4 = Conv(3, 3, features + 4 * growth, features, **g)

    @staticmethod
    def apply(params, x):
        p = params.get("params", params)
        feats = [x]
        for i in range(4):
            feats.append(_leaky(conv(torch.cat(feats, dim=-1),
                                     p[f"Conv_{i}"])))
        return x + 0.2 * conv(torch.cat(feats, dim=-1), p["Conv_4"])


class RRDB(TreeModule):
    def __init__(self, features: int, growth: int, *, generator=None):
        super().__init__()
        for j in range(3):
            self.add_module(f"DenseBlock_{j}",
                            DenseBlock(features, growth, generator=generator))

    @staticmethod
    def apply(params, x):
        p = params.get("params", params)
        h = x
        for j in range(3):
            h = DenseBlock.apply(p[f"DenseBlock_{j}"], h)
        return x + 0.2 * h


class ESRGANLite(TreeModule):
    def __init__(self, scale: int = 4, channels: int = 3, features: int = 48,
                 growth: int = 24, n_blocks: int = 4, *, generator=None):
        super().__init__()
        self.scale, self.channels, self.features = scale, channels, features
        self.growth, self.n_blocks = growth, n_blocks
        g = dict(generator=generator)
        f = features
        convs = [Conv(3, 3, channels, f, **g), Conv(3, 3, f, f, **g)]
        convs += [Conv(3, 3, f, f * st * st, **g) for st in _steps(scale)]
        convs += [Conv(3, 3, f, f, **g), Conv(3, 3, f, channels, **g)]
        for i, c in enumerate(convs):
            self.add_module(f"Conv_{i}", c)
        for k in range(n_blocks):
            self.add_module(f"RRDB_{k}", RRDB(f, growth, **g))

    def apply(self, params, x):
        p = params.get("params", params)
        fea = conv(x, p["Conv_0"])
        body = fea
        for k in range(self.n_blocks):
            body = RRDB.apply(p[f"RRDB_{k}"], body)
        fea = fea + conv(body, p["Conv_1"])
        i = 2
        for step in _steps(self.scale):
            fea = _leaky(pixel_shuffle(conv(fea, p[f"Conv_{i}"]), step))
            i += 1
        fea = _leaky(conv(fea, p[f"Conv_{i}"]))
        out = conv(fea, p[f"Conv_{i + 1}"])
        return out + upsample_nearest(x[..., :self.channels], self.scale)


def params_from_jax(tree: dict, *, device="cuda") -> dict:
    """A flax ESRGANLite tree (numpy leaves) → the port's tree of float32
    tensors on ``device``; ``RRDB_k`` / ``DenseBlock_j`` / ``Conv_i`` keep
    their names (each is looked up by its number, never by sort order)."""
    out = tree_from_jax(tree, device=device)
    p = out["params"]
    blocks = numbered(p, "RRDB")
    if not blocks or set(numbered(p, "Conv") + blocks) != set(p) or not all(
            numbered(p[r], "DenseBlock") == [f"DenseBlock_{j}"
                                             for j in range(3)]
            for r in blocks):
        raise ValueError(f"not an ESRGANLite tree: {sorted(p)}")
    return out
