"""SwinIR (Liang et al. 2021, "SwinIR: Image Restoration Using Swin
Transformer", arXiv:2108.10257; JingyunLiang/SwinIR
``models/network_swinir.py``) with its real-world upsampler
(``upsampler="nearest+conv"``, ``resi_connection="1conv"``, ``img_range
1``), at the widths of the published real-world x4 model SwinIR-M
(``003_realSR_BSRGAN_DFO_s64w8_SwinIR-M_x4_GAN.pth``): 6 residual Swin
transformer blocks (RSTBs) of 6 Swin blocks, 180 features, 6 heads, window
8, MLP ratio 2, 64 features in the upsampler. Eval mode (no drop-path or
dropout); on NHWC RGB frames in [0, 1]:

  x = reflect-pad bottom and right to multiples of 8; x = x - mean
  f0 = conv_first(x); t = LN_pe(tokens(f0))
  per RSTB (u = t), per block j with shift s = 0 if j is even else 4:
    a = proj(attention(qkv(LN1(t)), s)); t = t + a
    t = t + fc2(GELU(fc1(LN2(t))))
  then t = tokens(conv(grid(t))) + u
  f = conv_after_body(grid(LN(t))) + f0
  f = leaky_0.01(conv_before_upsample(f))
  out = the HR stage (``upsample.nearest_conv_x4``) + mean, cropped to 4H x 4W

where ``attention`` is the shifted-window attention of
``ops/window_attention`` (relative-position bias per head, the shift mask
on shifted blocks). Every odd block shifts: the published blocks drop the
shift only when the constructor's ``img_size`` (64 for SwinIR-M) is at
most the window, whatever the frame.

Tree (flax-style names): ``conv_first``, ``patch_norm``,
``RSTB_i/Block_j/{norm1, qkv, rel_bias, proj, norm2, fc1, fc2}``,
``RSTB_i/conv``, ``norm``, ``conv_after_body``, ``conv_before_upsample``,
``conv_up1``, ``conv_up2``, ``conv_hr``, ``conv_last``. It loads a
published state dict or weights drawn from a seed that ``meta.json``
states (:func:`load_swinir`).

With grad off, a float32 frame on the card runs its attention through the
kernel (:func:`..ops.window_attention.window_attention`, 36 launches a
SwinIR-M frame) and its linears through the linear kernel
(:func:`..ops.linear_tc.linear_tc`, 144 launches), fc1's exact GELU and
the residual adds after proj and fc2 in the linear kernel's epilogue;
LayerNorm is PyTorch's; conv_first, the RSTB convs, conv_after_body and
conv_before_upsample are cuDNN's (f32 under the caller's
``conv_precision``). Other frames (grad on, another precision on the card,
the CPU) take the plain versions: the attention that materialises the
scores, and ``torch.addmm`` with f32 products in full and the epilogue in
PyTorch.
"""

from __future__ import annotations

import math
import pathlib

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import linear_tc
from ..ops.window_attention import (WINDOW, relative_bias, serves,
                                    window_attention,
                                    window_attention_reference)
from ..runtime.device import full_f32_matmul
from ..utils.profiling import span
from .layers import (Conv, Dense, LayerNorm, TreeModule, empty_module,
                     layer_norm, store_conv_kernels_oihw_)
from .upsample import conv_cm, nearest_conv_x4

#: the published real-world model's RGB mean (float32, as its tensor)
RGB_MEAN = (0.4488, 0.4371, 0.4040)
#: SwinIR-M's widths: ``main_test_swinir.py --task real_sr --scale 4``
PUBLISHED = {"embed": 180, "depths": (6,) * 6, "heads": (6,) * 6,
             "features": 64}
#: the nearest+conv upsampler's scale, the MLP's hidden width over the
#: embedding, the RGB channels in and out: one value in every published
#: real-world model (the window is the kernel's, ``WINDOW``)
SCALE, MLP_RATIO, CHANNELS = 4, 2, 3
_LEAKY_BEFORE_UPSAMPLE = 0.01     # nn.LeakyReLU's default slope


class RelativePositionBias(nn.Module):
    """``table`` [(2 WINDOW - 1)², heads]; truncated normal, std 0.02, at
    init, as the published block draws it."""

    def __init__(self, heads: int, *, generator=None):
        super().__init__()
        self.table = nn.Parameter(torch.empty(((2 * WINDOW - 1) ** 2,
                                               heads)))
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        nn.init.trunc_normal_(self.table, std=0.02, generator=generator)


class SwinBlock(TreeModule):
    def __init__(self, embed, heads, *, generator=None):
        super().__init__()
        g = dict(generator=generator)
        hidden = embed * MLP_RATIO
        self.norm1 = LayerNorm(embed)
        self.qkv = Dense(embed, 3 * embed, **g)
        self.rel_bias = RelativePositionBias(heads, **g)
        self.proj = Dense(embed, embed, **g)
        self.norm2 = LayerNorm(embed)
        self.fc1 = Dense(embed, hidden, **g)
        self.fc2 = Dense(hidden, embed, **g)


class RSTB(TreeModule):
    def __init__(self, embed, depth, heads, *, generator=None):
        super().__init__()
        for j in range(depth):
            self.add_module(f"Block_{j}", SwinBlock(embed, heads,
                                                    generator=generator))
        self.conv = Conv(3, 3, embed, embed, generator=generator)


def _linear(x, leaf, epilogue="none", residual=None, out=None):
    """``epilogue(x @ kernel + bias)`` with a Dense leaf (kernel [in,
    out]; ``ops.linear_tc``'s epilogues): the linear kernel for a float32
    ``x`` on the card with grad off, else the plain version; each call
    counted on :class:`SwinIR`. ``out`` may be ``residual``."""
    if not torch.is_grad_enabled() and linear_tc.serves(x):
        SwinIR.linear_kernel_calls += 1
        return linear_tc.linear_tc(x, leaf["kernel"], leaf["bias"], epilogue,
                                   residual=residual, out=out)
    SwinIR.plain_linear_calls += 1
    return linear_tc.linear_reference(x, leaf["kernel"], leaf["bias"],
                                      epilogue, residual=residual, out=out)


def _tokens(f):
    """[1, C, H, W] → [H W, C], row-major: a view of a channels-last
    frame, a copy of an NCHW one (cuDNN's f32 convs return NCHW; a
    transposed view would make every later residual add and LayerNorm
    input strided)."""
    return f[0].permute(1, 2, 0).reshape(-1, f.shape[1]).contiguous()


def _grid(t, h, w):
    """[H W, C] → [1, C, H, W] (a channels-last view)."""
    return t.reshape(h, w, -1).permute(2, 0, 1)[None]


class SwinIR(TreeModule):
    """SwinIR with the nearest+conv upsampler at 4x (see the module's
    docstring). The class counts, frame by frame, the Swin blocks whose
    attention the kernel's wrapper served (``attention_kernel_blocks``:
    the kernel on the card, its plain version on the CPU) and those that
    took the plain attention directly (``plain_attention_blocks``), the
    linears launched on the linear kernel (``linear_kernel_calls``) and
    those run plain (``plain_linear_calls``), and the convs served by the
    conv kernel and by cuDNN (``conv3x3_convs``, ``cudnn_convs``)."""

    attention_kernel_blocks = 0
    plain_attention_blocks = 0
    linear_kernel_calls = 0
    plain_linear_calls = 0
    conv3x3_convs = 0
    cudnn_convs = 0

    def __init__(self, embed: int = 180, depths=(6,) * 6, heads=(6,) * 6,
                 features: int = 64, *, generator=None):
        super().__init__()
        if len(depths) != len(heads):
            raise ValueError(f"depths {depths} and heads {heads} differ in "
                             "length")
        self.embed, self.features = embed, features
        self.depths, self.heads = tuple(depths), tuple(heads)
        self._means: dict = {}
        g = dict(generator=generator)
        self.conv_first = Conv(3, 3, CHANNELS, embed, **g)
        self.patch_norm = LayerNorm(embed)
        for i, (d, nh) in enumerate(zip(depths, heads)):
            self.add_module(f"RSTB_{i}", RSTB(embed, d, nh, **g))
        self.norm = LayerNorm(embed)
        self.conv_after_body = Conv(3, 3, embed, embed, **g)
        self.conv_before_upsample = Conv(3, 3, embed, features, **g)
        for name in ("conv_up1", "conv_up2", "conv_hr"):
            self.add_module(name, Conv(3, 3, features, features, **g))
        self.conv_last = Conv(3, 3, features, CHANNELS, **g)

    @torch.no_grad()
    def load_tree(self, tree: dict) -> "SwinIR":
        """:meth:`TreeModule.load_tree`, each conv kernel first given OIHW
        storage under its HWIO shape (``layers.store_conv_kernels_oihw_``),
        each block's relative-position bias gathered once after
        (``ops.window_attention.relative_bias``, kept on its table)."""
        store_conv_kernels_oihw_(self)
        super().load_tree(tree)
        for m in self.modules():
            if isinstance(m, RelativePositionBias):
                relative_bias(m.table)
        return self

    def _mean(self, x):
        """The RGB mean [C] as float32 values in ``x``'s dtype, on its
        device (made once per device and dtype: no upload a frame)."""
        key = (x.device, x.dtype)
        if key not in self._means:
            self._means[key] = torch.tensor(
                RGB_MEAN, dtype=torch.float32).to(
                    x.device).to(x.dtype)
        return self._means[key]

    def apply(self, params, x):
        """[B, H, W, C] in [0, 1] → [B, 4H, 4W, C], a frame at a time."""
        p = params.get("params", params)
        with full_f32_matmul():
            outs = [self._frame(p, x[i]) for i in range(x.shape[0])]
        return outs[0][None] if len(outs) == 1 else torch.stack(outs)

    def _frame(self, p, x):
        """One frame [H, W, C] → [4H, 4W, C]. The LR features go to the HR
        stage as a temporary, so that neither they nor the trunk's tokens
        outlive conv_up1."""
        h, w = x.shape[:2]
        y = nearest_conv_x4(self._features(p, x), p["conv_up1"],
                            p["conv_up2"], p["conv_hr"], p["conv_last"],
                            SwinIR)
        return y[0, :4 * h, :4 * w] + self._mean(x)

    def _features(self, p, x):
        """The trunk (span ``model.trunk``: padding, conv_first, the RSTBs,
        conv_after_body), then conv_before_upsample and its leaky ReLU:
        ``[1, features, Hp, Wp]``, contiguous."""
        h, w = x.shape[:2]
        with span("model.trunk"):
            xc = x[..., :CHANNELS].permute(2, 0, 1)[None]
            hp, wp = h + (-h) % WINDOW, w + (-w) % WINDOW
            if (hp, wp) != (h, w):
                xc = F.pad(xc, (0, wp - w, 0, hp - h), mode="reflect")
            xc = (xc - self._mean(x).view(1, -1, 1, 1)).contiguous(
                memory_format=torch.channels_last)
            f0 = conv_cm(xc, p["conv_first"], SwinIR)   # channels last
            t = layer_norm(_tokens(f0), p["patch_norm"])
            for i, (depth, heads) in enumerate(zip(self.depths, self.heads)):
                with span("model.rstb"):
                    t = self._rstb(p[f"RSTB_{i}"], t, hp, wp, depth, heads)
            f = conv_cm(_grid(layer_norm(t, p["norm"]), hp, wp),
                        p["conv_after_body"], SwinIR) + f0
        f = conv_cm(f, p["conv_before_upsample"], SwinIR)
        return F.leaky_relu(f, _LEAKY_BEFORE_UPSAMPLE).contiguous()

    def _rstb(self, r, t, hp, wp, depth, heads):
        u = t
        for j in range(depth):
            shift = 0 if j % 2 == 0 else WINDOW // 2
            t = self._block(r[f"Block_{j}"], t, hp, wp, heads, shift)
        return _tokens(conv_cm(_grid(t, hp, wp), r["conv"], SwinIR)) + u

    def _block(self, b, t, hp, wp, heads, shift):
        qkv = _linear(layer_norm(t, b["norm1"]), b["qkv"])
        bias = relative_bias(b["rel_bias"]["table"])
        scale = (t.shape[1] // heads) ** -0.5
        if not torch.is_grad_enabled() and serves(qkv):
            SwinIR.attention_kernel_blocks += 1
            a = window_attention(qkv, bias, hp, wp, heads, shift, scale)
        else:
            SwinIR.plain_attention_blocks += 1
            a = window_attention_reference(qkv, bias, hp, wp, heads, shift,
                                           scale)
        t = _linear(a, b["proj"], "residual", t)
        y = _linear(layer_norm(t, b["norm2"]), b["fc1"], "gelu")
        # proj's output is the block's own: with grad off fc2 adds into it
        out = None if torch.is_grad_enabled() else t
        return _linear(y, b["fc2"], "residual", t, out)


# -- published weights ------------------------------------------------------

def _dims(meta: dict) -> dict:
    """The widths a ``meta.json`` states, the published ones by default."""
    dims = dict(PUBLISHED)
    for k in ("embed", "features"):
        if k in meta:
            dims[k] = int(meta[k])
    for k in ("depths", "heads"):
        if k in meta:
            dims[k] = tuple(int(v) for v in meta[k])
    return dims


def published_params(embed=180, depths=(6,) * 6, heads=(6,) * 6,
                     features=64):
    """``[(published key, port path, published shape, module)]`` of every
    parameter of the published SwinIR in its parameter order
    (``named_parameters``); ``module`` names the parameter's module with
    its layer and block numbers dropped (``attn.qkv``, ``conv``,
    ``conv_last``, ...)."""
    e, hidden = embed, embed * MLP_RATIO
    out = []

    def add(name, path, module, kind, n_out, n_in=None):
        if kind == "conv":
            out.append((f"{name}.weight", (*path, "kernel"),
                        (n_out, n_in, 3, 3), module))
        elif kind == "linear":
            out.append((f"{name}.weight", (*path, "kernel"), (n_out, n_in),
                        module))
        else:
            out.append((f"{name}.weight", (*path, "scale"), (n_out,),
                        module))
        out.append((f"{name}.bias", (*path, "bias"), (n_out,), module))

    add("conv_first", ("conv_first",), "conv_first", "conv", e, CHANNELS)
    add("patch_embed.norm", ("patch_norm",), "norm", "norm", e)
    for i, (depth, nh) in enumerate(zip(depths, heads)):
        for j in range(depth):
            pre = f"layers.{i}.residual_group.blocks.{j}"
            blk = (f"RSTB_{i}", f"Block_{j}")
            add(f"{pre}.norm1", (*blk, "norm1"), "norm", "norm", e)
            out.append((f"{pre}.attn.relative_position_bias_table",
                        (*blk, "rel_bias", "table"),
                        ((2 * WINDOW - 1) ** 2, nh),
                        "attn.relative_position_bias_table"))
            add(f"{pre}.attn.qkv", (*blk, "qkv"), "attn.qkv", "linear",
                3 * e, e)
            add(f"{pre}.attn.proj", (*blk, "proj"), "attn.proj", "linear",
                e, e)
            add(f"{pre}.norm2", (*blk, "norm2"), "norm", "norm", e)
            add(f"{pre}.mlp.fc1", (*blk, "fc1"), "mlp.fc1", "linear",
                hidden, e)
            add(f"{pre}.mlp.fc2", (*blk, "fc2"), "mlp.fc2", "linear",
                e, hidden)
        add(f"layers.{i}.conv", (f"RSTB_{i}", "conv"), "conv", "conv", e, e)
    add("norm", ("norm",), "norm", "norm", e)
    add("conv_after_body", ("conv_after_body",), "conv_after_body", "conv",
        e, e)
    add("conv_before_upsample.0", ("conv_before_upsample",),
        "conv_before_upsample", "conv", features, e)
    for name in ("conv_up1", "conv_up2", "conv_hr"):
        add(name, (name,), name, "conv", features, features)
    add("conv_last", ("conv_last",), "conv_last", "conv", CHANNELS, features)
    return out


#: buffers of a published state dict that are worked out again, not read
_BUFFERS = (".attn.relative_position_index", ".attn_mask")


def _to_port(key: str, value: np.ndarray) -> np.ndarray:
    """A published tensor in the port's layout: conv weights OIHW → HWIO,
    linear weights [out, in] → [in, out]."""
    if key.endswith(".weight") and value.ndim == 4:
        return np.ascontiguousarray(value.transpose(2, 3, 1, 0))
    if key.endswith(".weight") and value.ndim == 2:
        return np.ascontiguousarray(value.T)
    return value


def tree_from_state_dict(sd: dict, **dims) -> dict:
    """A published SwinIR state dict (bare or wrapped in ``params_ema`` /
    ``params``; the buffers ``relative_position_index`` and ``attn_mask``
    are dropped) → the port's ``{"params": ...}`` tree of numpy float32
    leaves. Raises ValueError on a missing, extra or misshapen key."""
    for wrapper in ("params_ema", "params"):
        if isinstance(sd.get(wrapper), dict):
            sd = sd[wrapper]
            break
    sd = {k: v for k, v in sd.items() if not k.endswith(_BUFFERS)}
    params = published_params(**dims)
    want = {key for key, *_ in params}
    missing, extra = sorted(want - set(sd)), sorted(set(sd) - want)
    if missing or extra:
        raise ValueError(f"not a SwinIR state dict of {dims}: missing "
                         f"{missing[:4]}, extra {extra[:4]}")
    tree: dict = {}
    for key, path, shape, _ in params:
        v = np.asarray(torch.as_tensor(sd[key]).cpu(), dtype=np.float32)
        if v.shape != shape:
            raise ValueError(f"{key}: shape {v.shape}; expected {shape}")
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = _to_port(key, v)
    return {"params": tree}


#: what a seeded ``init`` in ``meta.json`` states, word for word, so that a
#: reader without the port draws the same tensors
INIT_RNG = "numpy.random.default_rng(seed)"
INIT_ORDER = ("conv_first, patch_embed.norm, then for i = 0 .. n_layers - 1: "
              "layers.<i>.residual_group.blocks.<j>.{norm1, "
              "attn.relative_position_bias_table, attn.qkv, attn.proj, "
              "norm2, mlp.fc1, mlp.fc2} for j = 0 .. depth - 1 and "
              "layers.<i>.conv; norm, conv_after_body, "
              "conv_before_upsample.0, conv_up1, conv_up2, conv_hr, "
              "conv_last; each weight before its bias")
INIT_VALUE = "float32(offset + std * rng.standard_normal(shape))"
INIT_STD = ("conv and linear weights: scale[<module>] * sqrt(1 / fan_in), "
            "fan_in = in * 3 * 3 or in; relative_position_bias_table: "
            "scale[\"table\"]; LayerNorm weights (offset 1) and biases: "
            "scale[\"norm\"]; conv and linear biases: scale[\"bias\"]; "
            "offset 0 but for LayerNorm weights; a bias that "
            "init[\"bias\"] gives by module replaces its draw")
_INIT_KEYS = {"rng", "seed", "order", "value", "std", "scale", "bias"}


def seeded_state_dict(init: dict, **dims) -> dict:
    """The state dict (published keys and layouts, float32 numpy) that a
    ``meta.json`` ``init`` describes: one ``numpy.random.default_rng(seed)``
    draws every parameter in the published order as ``offset + std *
    standard_normal(shape)`` (float64, then cast to float32), with the
    offset and std that :data:`INIT_STD` states from ``init["scale"]``;
    ``init["bias"]`` may give a module's bias, which replaces its draw."""
    stated = tuple(init.get(k) for k in ("rng", "order", "value", "std"))
    if set(init) - _INIT_KEYS or stated != (INIT_RNG, INIT_ORDER,
                                            INIT_VALUE, INIT_STD):
        raise ValueError(f"init states another draw than this loader's: "
                         f"keys {sorted(init)}, rng, order, value and std "
                         f"{stated}")
    rng = np.random.default_rng(int(init["seed"]))
    scale = init["scale"]
    sd = {}
    for key, _, shape, module in published_params(**dims):
        offset = 0.0
        if module == "norm":
            std = scale["norm"]
            offset = 1.0 if key.endswith(".weight") else 0.0
        elif module == "attn.relative_position_bias_table":
            std = scale["table"]
        elif key.endswith(".bias"):
            std = scale["bias"]
        else:
            std = scale[module] * math.sqrt(1.0 / math.prod(shape[1:]))
        sd[key] = (offset + std * rng.standard_normal(shape)).astype(
            np.float32)
        if key.endswith(".bias") and module in init.get("bias", {}):
            sd[key] = np.asarray(init["bias"][module], dtype=np.float32)
    return sd


def load_swinir(model_dir, meta: dict, *, device="cuda"):
    """``(model, params)`` of a SwinIR checkpoint directory whose
    ``meta.json`` (``meta``) names a published state dict
    (``meta["state_dict"]``, a ``.pth`` beside it, read with
    ``torch.load(weights_only=True)``) or a seeded init (``meta["init"]``,
    :func:`seeded_state_dict`). ``meta`` may give ``embed``, ``depths``,
    ``heads`` and ``features`` (default: SwinIR-M's, :data:`PUBLISHED`);
    the scale, window, MLP ratio and channels are the published ones."""
    dims = _dims(meta)
    if "state_dict" in meta:
        sd = torch.load(pathlib.Path(model_dir) / meta["state_dict"],
                        map_location="cpu", weights_only=True)
    elif "init" in meta:
        sd = seeded_state_dict(meta["init"], **dims)
    else:
        raise ValueError(f"{model_dir}: meta.json names neither a "
                         "state_dict nor an init")
    tree = tree_from_state_dict(sd, **dims)
    model = empty_module(lambda: SwinIR(**dims), device)
    model.load_tree(tree)
    return model, model.tree()
