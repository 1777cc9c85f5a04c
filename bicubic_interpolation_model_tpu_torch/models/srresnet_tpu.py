"""SRResNetTPU (counterpart of
``bicubic_interpolation_model_tpu/models/srresnet_tpu.py``): an EDSR-style
body of ``n_blocks`` residual conv pairs at ``features`` channels (scaled
``res_scale``), all convs at LR resolution, one depth-to-space at the end
and a global skip of the nearest-upsampled input. flax tree ``Conv_0 ..
Conv_{2n+2}``.
"""

from __future__ import annotations

import torch

from .espcn import params_from_jax  # the same Conv_0 .. Conv_N tree
from .layers import Conv, TreeModule, conv, pixel_shuffle, upsample_nearest

__all__ = ["SRResNetTPU", "params_from_jax"]


class SRResNetTPU(TreeModule):
    def __init__(self, scale: int = 4, channels: int = 3,
                 features: int = 128, n_blocks: int = 6,
                 res_scale: float = 0.2, *, generator=None):
        super().__init__()
        self.scale, self.channels, self.features = scale, channels, features
        self.n_blocks, self.res_scale = n_blocks, res_scale
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
        h = conv(x, p["Conv_0"])
        skip = h
        for k in range(self.n_blocks):
            r = torch.relu(conv(h, p[f"Conv_{2 * k + 1}"]))
            r = conv(r, p[f"Conv_{2 * k + 2}"])
            h = h + self.res_scale * r
        n = 2 * self.n_blocks
        h = conv(h, p[f"Conv_{n + 1}"]) + skip
        h = conv(h, p[f"Conv_{n + 2}"])
        return pixel_shuffle(h, s) + upsample_nearest(
            x[..., :self.channels], s)
