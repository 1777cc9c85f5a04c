"""Shared model layers, NHWC at their public functions with flax's
parameter layouts (conv kernels HWIO, dense kernels [in, out]), so
checkpoints of the JAX package load without transposition.

:class:`TreeModule` names its children as flax names its submodules
(``Conv_0``, ``RRDB_1/DenseBlock_2/Conv_3``, ``dense1``): its
:meth:`~TreeModule.tree` is the flax parameter tree of the module's own
parameters, and its forward is :meth:`~TreeModule.apply` on that tree, so a
cast copy of the tree (bfloat16, float64) runs the same function."""

from __future__ import annotations

import math

import numpy as np
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


def pixel_shuffle(x: torch.Tensor, scale: int) -> torch.Tensor:
    """[B, H, W, C*s*s] -> [B, H*s, W*s, C] (depth-to-space) in the JAX
    package's NHWC order: input channel ``(a*s + b)*C + c`` goes to output
    pixel ``(s*Y + a, s*X + b)``, channel ``c``. This is not
    ``torch.nn.functional.pixel_shuffle``, whose channel order is
    ``c*s*s + a*s + b``."""
    b, h, w, c = x.shape
    s = scale
    cout = c // (s * s)
    y = x.reshape(b, h, w, s, s, cout)
    return y.permute(0, 1, 3, 2, 4, 5).reshape(b, h * s, w * s, cout)


def upsample_nearest(x: torch.Tensor, scale: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, H*s, W*s, C], each pixel repeated s x s."""
    return x.repeat_interleave(scale, dim=1).repeat_interleave(scale, dim=2)


def conv(x: torch.Tensor, leaf: dict) -> torch.Tensor:
    """:func:`conv_nhwc` with a ``{"kernel", "bias"}`` tree leaf."""
    return conv_nhwc(x, leaf["kernel"], leaf["bias"])


def dense(x: torch.Tensor, leaf: dict) -> torch.Tensor:
    """``x @ kernel (+ bias)`` with a flax Dense leaf (kernel [in, out])."""
    y = x @ leaf["kernel"]
    return y + leaf["bias"] if "bias" in leaf else y


def pixel_shuffle_upsample(x: torch.Tensor, kernel: torch.Tensor,
                           bias: torch.Tensor) -> torch.Tensor:
    """Stride-S transposed conv with kernel size S: each input pixel emits
    an SxS block, out[sY+a, sX+b, o] = sum_i K[a,b,o,i] x[Y,X,i] + bias."""
    s = kernel.shape[0]
    y = torch.einsum("byxi,pqoi->bypxqo", x, kernel)
    b, h, _, w, _, o = y.shape
    return y.reshape(b, h * s, w * s, o) + bias


def _lecun_normal_(t: torch.Tensor, fan_in: int, generator,
                   gain: float = 1.0) -> torch.Tensor:
    # flax's default conv and dense kernel init: truncated normal, variance
    # gain/fan_in (gain 2 is flax's he_normal)
    std = math.sqrt(gain / fan_in) / 0.87962566103423978
    return nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std,
                                 generator=generator)


class Conv(nn.Module):
    """flax ``nn.Conv`` counterpart: ``kernel`` [kh, kw, in, out], ``bias``."""

    def __init__(self, kh: int, kw: int, n_in: int, n_out: int, *,
                 generator=None):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty((kh, kw, n_in, n_out)))
        self.bias = nn.Parameter(torch.empty(n_out))
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        kh, kw, n_in, _ = self.kernel.shape
        _lecun_normal_(self.kernel, kh * kw * n_in, generator)
        self.bias.zero_()

    def forward(self, x):
        return conv_nhwc(x, self.kernel, self.bias)


class Dense(nn.Module):
    """flax ``nn.Dense`` counterpart: ``kernel`` [in, out], ``bias`` unless
    ``use_bias=False``. ``init`` "lecun" (flax's default) or "he" (flax's
    he_normal), both truncated normals."""

    def __init__(self, n_in: int, n_out: int, *, use_bias: bool = True,
                 init: str = "lecun", generator=None):
        super().__init__()
        self.gain = 2.0 if init == "he" else 1.0
        self.kernel = nn.Parameter(torch.empty((n_in, n_out)))
        if use_bias:
            self.bias = nn.Parameter(torch.empty(n_out))
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        _lecun_normal_(self.kernel, self.kernel.shape[0], generator,
                       self.gain)
        if hasattr(self, "bias"):
            self.bias.zero_()

    def forward(self, x):
        return dense(x, _leaves(self))


def _leaves(layer: nn.Module) -> dict:
    return dict(layer.named_parameters(recurse=False))


def tree_map(fn, node):
    """``fn`` on every leaf of a nested dict, the structure kept."""
    if isinstance(node, dict):
        return {k: tree_map(fn, v) for k, v in node.items()}
    return fn(node)


def tree_from_jax(tree: dict, *, device="cuda") -> dict:
    """A flax parameter tree of numpy (or jax/torch) arrays → the same tree
    ``{"params": ...}`` of float32 tensors on ``device``."""
    from ..runtime.device import resolve_device

    dev = resolve_device(device)

    def convert(leaf):
        if isinstance(leaf, torch.Tensor):
            return leaf.detach().to(dev, torch.float32)
        return torch.as_tensor(np.array(leaf, dtype=np.float32), device=dev)
    return {"params": tree_map(convert, tree.get("params", tree))}


def tree_to_numpy(tree: dict) -> dict:
    """The reverse of :func:`tree_from_jax`: a tree of tensors (any device)
    → the same tree of float32 numpy arrays, as the JAX package holds
    parameters on the host."""
    return tree_map(lambda t: t.detach().to("cpu", torch.float32).numpy(),
                    tree)


def init_tree_(model: nn.Module, generator=None) -> nn.Module:
    """Draw every leaf layer's parameters of ``model`` anew, in place, with
    flax's initialisers (conv and dense kernels lecun- or he-normal, the
    upsample glorot-uniform, biases zero), on the device the parameters lie
    on: ``generator`` is a ``torch.Generator`` of that device."""
    for m in model.modules():
        if isinstance(m, (Conv, Dense, PixelShuffleUpsample)):
            m.reset_parameters(generator)
    return model


def numbered(p: dict, prefix: str) -> list[str]:
    """The names ``<prefix>_<i>`` of a flax tree level in the order of
    ``i`` (flax numbers submodules by creation; a string sort would put
    ``Conv_10`` before ``Conv_2``). Raises unless ``i`` runs 0..n-1."""
    idx = sorted(int(k[len(prefix) + 1:]) for k in p
                 if k.startswith(prefix + "_")
                 and k[len(prefix) + 1:].isdigit())
    if idx != list(range(len(idx))):
        raise ValueError(f"{prefix}_<i> names are not numbered 0..n-1: "
                         f"{idx}")
    return [f"{prefix}_{i}" for i in idx]


def empty_module(make, device) -> nn.Module:
    """``make()`` built without initialising its parameters (on the meta
    device), then given uninitialised storage on ``device``: for a
    checkpoint that fills every leaf (``load_tree`` checks that it does)."""
    with torch.device("meta"):
        module = make()
    return module.to_empty(device=device)


class TreeModule(nn.Module):
    """A module whose children carry flax's submodule names; leaf layers
    (:class:`Conv`, :class:`Dense`, :class:`PixelShuffleUpsample`) hold
    ``kernel`` and ``bias``. Subclasses define ``apply(params, x)`` on the
    tree."""

    def tree(self) -> dict:
        """The flax-style ``{"params": ...}`` tree of this module's own
        parameters (no copies)."""
        def sub(m):
            leaf = (Conv, Dense, PixelShuffleUpsample)
            return {name: _leaves(c) if isinstance(c, leaf) else sub(c)
                    for name, c in m.named_children()}
        return {"params": sub(self)}

    @torch.no_grad()
    def load_tree(self, tree: dict) -> "TreeModule":
        """Copy a flax-style tree (numpy or torch leaves) into the module;
        raises on a missing, extra or misshapen leaf."""
        dev = next(self.parameters()).device
        src = tree_from_jax(tree, device=dev)["params"]

        def copy(dst, s, path):
            if set(dst) != set(s):
                raise ValueError(f"{path or 'tree'}: checkpoint has "
                                 f"{sorted(s)}, model {sorted(dst)}")
            for k, v in dst.items():
                if isinstance(v, dict):
                    copy(v, s[k], f"{path}{k}/")
                elif v.shape != s[k].shape:
                    raise ValueError(f"{path}{k}: checkpoint shape "
                                     f"{tuple(s[k].shape)}, model "
                                     f"{tuple(v.shape)}")
                else:
                    v.copy_(s[k])
        copy(self.tree()["params"], src, "")
        return self

    def forward(self, x):
        return self.apply(self.tree(), x)


class PixelShuffleUpsample(nn.Module):
    """``kernel`` [S, S, out, in] (TFJS Conv2DTranspose storage), ``bias``
    [out]; glorot-uniform init like the JAX layer."""

    def __init__(self, features: int, scale: int, in_feat: int, *,
                 generator=None):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty((scale, scale, features,
                                                in_feat)))
        self.bias = nn.Parameter(torch.empty(features))
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        s, _, features, in_feat = self.kernel.shape
        fan_in, fan_out = features * s * s, in_feat * s * s
        lim = math.sqrt(6.0 / (fan_in + fan_out))
        nn.init.uniform_(self.kernel, -lim, lim, generator=generator)
        self.bias.zero_()

    def forward(self, x):
        return pixel_shuffle_upsample(x, self.kernel, self.bias)
