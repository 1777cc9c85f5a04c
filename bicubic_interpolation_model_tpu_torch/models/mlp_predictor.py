"""The v1.0 / v2.0 model families: MLP weight predictors (counterpart of
``bicubic_interpolation_model_tpu/models/mlp_predictor.py``).

- v1.0 :class:`PatchMLP`: a flattened 4x4xC LR patch → 16 weights (dense
  hidden (128,) + relu, flax names ``Dense_0``, ``Dense_1``).
- v2.0 :class:`PixelMLP`: patch + (dx, dy) → 16 weights, dense 64 → 32 →
  16 (``dense1``, ``dense2``, ``dense_out`` with no bias), he-normal init;
  :func:`apply_max_norm` is its Keras max-norm(3) kernel constraint.

Both consume :func:`extract_pixel_features` and feed the 16-tap
:func:`..ops.learned.apply_weights`. ``ModelUpscaler`` does not serve them
(as in the JAX package); :func:`load_mlp` loads a committed checkpoint.
"""

from __future__ import annotations

import pathlib

import torch

from .layers import Dense, TreeModule, dense


class PatchMLP(TreeModule):
    """v1.0: flattened 4x4xC patch → 16 weights."""

    def __init__(self, hidden: tuple[int, ...] = (128,), n_weights: int = 16,
                 n_in: int = 64, *, generator=None):
        super().__init__()
        self.hidden, self.n_weights = tuple(hidden), n_weights
        widths = (n_in,) + self.hidden + (n_weights,)
        for i in range(len(widths) - 1):
            self.add_module(f"Dense_{i}", Dense(widths[i], widths[i + 1],
                                                generator=generator))

    def apply(self, params, x):
        p = params.get("params", params)
        for i in range(len(self.hidden)):
            x = torch.relu(dense(x, p[f"Dense_{i}"]))
        return dense(x, p[f"Dense_{len(self.hidden)}"])


class PixelMLP(TreeModule):
    """v2.0: 4x4xC patch + (dx, dy) → 16 weights; 64-32-16 dense stack,
    he-normal init, no bias on the output layer."""

    def __init__(self, n_weights: int = 16, n_in: int = 66, *,
                 generator=None):
        super().__init__()
        self.n_weights = n_weights
        g = dict(init="he", generator=generator)
        self.dense1 = Dense(n_in, 64, **g)
        self.dense2 = Dense(64, 32, **g)
        self.dense_out = Dense(32, n_weights, use_bias=False, **g)

    @staticmethod
    def apply(params, x):
        p = params.get("params", params)
        x = torch.relu(dense(x, p["dense1"]))
        x = torch.relu(dense(x, p["dense2"]))
        return dense(x, p["dense_out"])


def apply_max_norm(params, max_norm: float = 3.0):
    """Keras maxNorm kernel constraint: every 2-D ``kernel`` leaf's columns
    (the incoming weights of one unit) clipped to L2 norm ``max_norm``; a
    new tree, other leaves as they are."""
    def clip(node, key=None):
        if isinstance(node, dict):
            return {k: clip(v, k) for k, v in node.items()}
        if key != "kernel" or node.dim() != 2:
            return node
        norms = torch.linalg.vector_norm(node, dim=0, keepdim=True)
        return node * torch.clamp(max_norm / norms.clamp(min=1e-7), max=1.0)
    return clip(params)


def extract_pixel_features(lr_float: torch.Tensor, h_sr: int, w_sr: int,
                           scale: int, convention: str = "train"):
    """Per-HR-pixel features: the 4x4 LR patch around the base cell
    flattened (64 floats for RGBA) + (dx, dy) → [H_sr*W_sr, 16*C + 2], on
    the frame's device. The 16 patch planes are shifted slices of the
    edge-padded LR image (the reference's clamped gathers), repeated to HR
    resolution."""
    from ..ops.learned import _edge_pad_chw, offset_map

    h_lr, w_lr, c = lr_float.shape
    padded = _edge_pad_chw(lr_float).permute(1, 2, 0)      # [Hl+3, Wl+3, C]
    patches = torch.stack([padded[dy:dy + h_lr, dx:dx + w_lr]
                           for dy in range(4) for dx in range(4)], dim=2)
    patches = patches.reshape(h_lr, w_lr, 16 * c)
    up = patches.repeat_interleave(scale, dim=0).repeat_interleave(
        scale, dim=1)[:h_sr, :w_sr]
    off = offset_map(h_sr, w_sr, float(scale), convention,
                     device=lr_float.device)
    return torch.cat([up, off], dim=-1).reshape(h_sr * w_sr, 16 * c + 2)


@torch.no_grad()
def super_resolve_mlp(model, params, lr_u8, scale: int = 4,
                      convention: str = "train",
                      include_offsets: bool = True):
    """SR through an MLP weight predictor and the 16-tap apply: uint8
    [H, W, C] → uint8 [H*S, W*S, C], on the device the params lie on."""
    from ..ops.learned import apply_weights
    from ..runtime.device import full_f32_matmul
    from .inference import _as_frames, _device_of, param_tree

    lr8 = _as_frames(lr_u8, _device_of(param_tree(params)))
    lr = lr8.float() / 255.0
    h_lr, w_lr = lr.shape[:2]
    h_sr, w_sr = h_lr * scale, w_lr * scale
    feats = extract_pixel_features(lr, h_sr, w_sr, scale, convention)
    if not include_offsets:
        feats = feats[:, :-2]
    with full_f32_matmul():
        w = model.apply(params, feats).reshape(h_sr, w_sr, 16)
    return apply_weights(lr8.float(), w).to(torch.uint8)


def load_mlp(model_dir, *, device="cuda"):
    """``(model, params, include_offsets)`` of a committed MLP checkpoint
    (``meta["model"]`` "PatchMLP" or "PixelMLP"), on ``device``."""
    from ..runtime.device import resolve_device
    from ..train import checkpoint
    from .layers import empty_module

    tree, meta = checkpoint.load(pathlib.Path(model_dir))
    name = meta.get("model")
    if name not in ("PatchMLP", "PixelMLP"):
        raise ValueError(f"{model_dir}: model {name!r} is not an MLP "
                         "predictor (PatchMLP, PixelMLP)")
    model = empty_module(PatchMLP if name == "PatchMLP" else PixelMLP,
                         resolve_device(device))
    model.load_tree(tree)
    return model, model.tree(), bool(meta.get("include_offsets",
                                              name == "PixelMLP"))
