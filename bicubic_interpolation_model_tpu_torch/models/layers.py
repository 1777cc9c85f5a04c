"""Shared model layers, NHWC at their public functions with flax's
parameter layouts (conv kernels HWIO), so checkpoints of the JAX package
load without transposition."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def conv_nhwc(x: torch.Tensor, kernel: torch.Tensor,
              bias: torch.Tensor) -> torch.Tensor:
    """SAME-padded stride-1 conv with an HWIO kernel, [B, H, W, I] →
    [B, H, W, O]. Odd kernel sizes only (SAME is then symmetric, as
    torch's "same")."""
    y = F.conv2d(x.permute(0, 3, 1, 2), kernel.permute(3, 2, 0, 1),
                 bias, padding="same")
    return y.permute(0, 2, 3, 1)


def pixel_shuffle_upsample(x: torch.Tensor, kernel: torch.Tensor,
                           bias: torch.Tensor) -> torch.Tensor:
    """Stride-S transposed conv with kernel size S: each input pixel emits
    an SxS block, out[sY+a, sX+b, o] = sum_i K[a,b,o,i] x[Y,X,i] + bias."""
    s = kernel.shape[0]
    y = torch.einsum("byxi,pqoi->bypxqo", x, kernel)
    b, h, _, w, _, o = y.shape
    return y.reshape(b, h * s, w * s, o) + bias


def _lecun_normal_(t: torch.Tensor, fan_in: int, generator) -> torch.Tensor:
    # flax's default conv kernel init: truncated normal, variance 1/fan_in
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    return nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std,
                                 generator=generator)


class Conv(nn.Module):
    """flax ``nn.Conv`` counterpart: ``kernel`` [kh, kw, in, out], ``bias``."""

    def __init__(self, kh: int, kw: int, n_in: int, n_out: int, *,
                 generator=None):
        super().__init__()
        k = torch.empty((kh, kw, n_in, n_out))
        self.kernel = nn.Parameter(_lecun_normal_(k, kh * kw * n_in,
                                                  generator))
        self.bias = nn.Parameter(torch.zeros(n_out))

    def forward(self, x):
        return conv_nhwc(x, self.kernel, self.bias)


class PixelShuffleUpsample(nn.Module):
    """``kernel`` [S, S, out, in] (TFJS Conv2DTranspose storage), ``bias``
    [out]; glorot-uniform init like the JAX layer."""

    def __init__(self, features: int, scale: int, in_feat: int, *,
                 generator=None):
        super().__init__()
        s = scale
        fan_in, fan_out = features * s * s, in_feat * s * s
        lim = math.sqrt(6.0 / (fan_in + fan_out))
        k = torch.empty((s, s, features, in_feat))
        self.kernel = nn.Parameter(nn.init.uniform_(k, -lim, lim,
                                                    generator=generator))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        return pixel_shuffle_upsample(x, self.kernel, self.bias)
