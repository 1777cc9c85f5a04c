"""ESRGAN-class SR models (RRDB generator, Wang et al. 2018).

:class:`ESRGANLite` is the counterpart of
``bicubic_interpolation_model_tpu/models/esrgan.py``: Residual-in-Residual
Dense Blocks with 0.2 residual scaling, pixel-shuffle upsampling by steps
of 2 (or the whole odd remainder), two convs on the HR grid, and a global
skip of the nearest-upsampled input. Leaky ReLUs have slope 0.2.

flax tree: ``Conv_0`` (head), ``RRDB_k/DenseBlock_j/Conv_i``, ``Conv_1``
(body end), one ``Conv`` per upsampling step, then the HR conv and the
output conv.

:class:`RRDBNet` is the published ESRGAN generator itself (arXiv:1809.00219;
xinntao/ESRGAN ``RRDBNet_arch.py``, the ``RRDB_ESRGAN_x4.pth`` model, and
Real-ESRGAN's ``RealESRGAN_x4plus``, basicsr's ``RRDBNet``): the same dense
blocks, then 4x by nearest-then-conv on the HR grid twice, ``conv_hr`` and
``conv_last``, with no global skip. It loads a published PyTorch state dict
in either key layout, or weights drawn from a seed that ``meta.json``
states (:func:`load_rrdbnet`).
"""

from __future__ import annotations

import math
import pathlib

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.conv3x3 import conv3x3_tc, conv3x3_tc_reference, serves
from ..utils.profiling import span
from .layers import Conv, TreeModule, conv, empty_module, numbered, \
    pixel_shuffle, tree_from_jax, upsample_nearest


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


def _conv_cm(x, leaf):
    """conv_first and conv_last: cuDNN's 3x3 conv on channel-major [B, C,
    H, W] with a ``{"kernel", "bias"}`` leaf, the HWIO kernel seen as OIHW
    (a view that is contiguous once :meth:`RRDBNet.load_tree` stored it
    so)."""
    RRDBNet.cudnn_convs += 1
    return F.conv2d(x, leaf["kernel"].permute(3, 2, 0, 1), leaf["bias"],
                    padding=1)


def _conv_tc(x, leaf, padding=1, **epilogue):
    """Every other conv: :func:`..ops.conv3x3.conv3x3_tc`, the conv, its
    bias and ``epilogue`` in one kernel on the card, on frames it
    :func:`..ops.conv3x3.serves`; other frames (another precision on the
    card) take its plain version, cuDNN and PyTorch's epilogue."""
    if not serves(x):
        RRDBNet.cudnn_convs += 1
        return conv3x3_tc_reference(x, leaf["kernel"], leaf["bias"],
                                    padding=padding, **epilogue)
    RRDBNet.conv3x3_convs += 1
    return conv3x3_tc(x, leaf["kernel"], leaf["bias"], padding=padding,
                      **epilogue)


def _interior(t):
    """The [H, W] interior of a [..., H + 2, W + 2] plane with a border."""
    return t[..., 1:-1, 1:-1]


def _dense_block_buffered(p, buf, features, out=None, outer=None):
    """One dense block of one frame in its own buffer ``buf`` [1, features +
    4 growth, H + 2, W + 2] with a zero border, whose channels
    ``[:features]`` hold the block's input: conv i reads the zero-padded
    prefix ``buf[:, :features + i growth]`` in place (contiguous at batch 1,
    padding 0) and writes its leaky ReLU into the interior of the next
    ``growth`` channels; conv_4 writes its scaled residual ``x + 0.2 y``
    into ``out`` (the interior of a slot of the next block's buffer), or a
    new tensor, and with ``outer`` (the RRDB's input) the RRDB's residual
    ``outer + 0.2 (x + 0.2 y)`` in its place. Each conv is one kernel
    with its epilogue."""
    c = features
    for i in range(4):
        leaf = p[f"Conv_{i}"]
        g = leaf["kernel"].shape[3]
        _conv_tc(buf[:, :c], leaf, padding=0, leaky=True,
                 out=_interior(buf[:, c:c + g]))
        c += g
    RRDBNet.buffered_blocks += 1
    return _conv_tc(buf, p["Conv_4"], padding=0, out=out,
                    residual=_interior(buf[:, :features]), alpha=0.2,
                    outer=outer)


def _trunk_buffered(p, fea, n_blocks, growth):
    """``fea + conv_body(RRDB_n(... RRDB_1(fea)))`` on one channel-major
    frame [1, F, H, W] in three zeroed buffers of F + 4 growth channels of
    [H + 2, W + 2], taken anew each call, whose border no write touches: an
    RRDB's input stays in its first buffer's slot ``[:, :F]`` until its
    last conv writes the outer residual into the slot of the second (free
    again by then), the next RRDB's first."""
    _, f, h, w = fea.shape
    a, b, c = (fea.new_zeros((1, f + 4 * growth, h + 2, w + 2))
               for _ in range(3))
    _interior(a[:, :f]).copy_(fea)
    for k in range(n_blocks):
        r = p[f"RRDB_{k}"]
        _dense_block_buffered(r["DenseBlock_0"], a, f,
                              out=_interior(b[:, :f]))
        _dense_block_buffered(r["DenseBlock_1"], b, f,
                              out=_interior(c[:, :f]))
        _dense_block_buffered(r["DenseBlock_2"], c, f,
                              out=_interior(b[:, :f]),
                              outer=_interior(a[:, :f]))
        a, b, c = b, c, a
    return _conv_tc(a[:, :f], p["Conv_1"], padding=0, residual=fea)


class RRDBNet(TreeModule):
    """The published ESRGAN generator at 4x, on NHWC frames in [0, 1]:

      fea = conv_first(x)
      fea = fea + conv_body(RRDB_n(... RRDB_1(fea)))
      fea = lrelu(conv_up1(nearest_2x(fea)))
      fea = lrelu(conv_up2(nearest_2x(fea)))
      out = conv_last(lrelu(conv_hr(fea)))

    flax-style tree: ``Conv_0`` (conv_first), ``RRDB_k/DenseBlock_j/Conv_i``
    (``body.k.rdb<j+1>.conv<i+1>``), ``Conv_1`` (conv_body), ``Conv_2`` and
    ``Conv_3`` (conv_up1, conv_up2), ``Conv_4`` (conv_hr), ``Conv_5``
    (conv_last). The spans ``model.trunk`` and ``model.upsample`` hold the
    two stages' host work while a profiler records.

    With grad off, each frame runs channel-major (NCHW) from conv_first to
    conv_last, every dense block in one zero-bordered buffer
    (:func:`_trunk_buffered`), every conv but conv_first and conv_last
    with its bias, leaky ReLU or residuals through :func:`_conv_tc` (one
    kernel on float32 card frames); with grad on, the batch runs through
    the NHWC dense blocks that concatenate, on cuDNN (``out=`` writes do
    not differentiate). The class counts, frame by frame, the dense blocks
    served either way (``buffered_blocks``, ``concatenated_blocks``) and
    the convs served by the kernel and by cuDNN (``conv3x3_convs``,
    ``cudnn_convs``)."""

    buffered_blocks = 0
    concatenated_blocks = 0
    conv3x3_convs = 0
    cudnn_convs = 0

    def __init__(self, scale: int = 4, channels: int = 3, features: int = 64,
                 growth: int = 32, n_blocks: int = 23, *, generator=None):
        super().__init__()
        if scale != 4:
            raise ValueError(f"RRDBNet upsamples 4x (two nearest-then-conv "
                             f"steps of 2), not {scale}x")
        self.scale, self.channels, self.features = scale, channels, features
        self.growth, self.n_blocks = growth, n_blocks
        g = dict(generator=generator)
        f = features
        convs = [Conv(3, 3, channels, f, **g)]
        convs += [Conv(3, 3, f, f, **g) for _ in range(4)]
        convs.append(Conv(3, 3, f, channels, **g))
        for i, c in enumerate(convs):
            self.add_module(f"Conv_{i}", c)
        for k in range(n_blocks):
            self.add_module(f"RRDB_{k}", RRDB(f, growth, **g))

    @torch.no_grad()
    def load_tree(self, tree: dict) -> "RRDBNet":
        """:meth:`TreeModule.load_tree`, each conv kernel first given OIHW
        storage under its HWIO shape (a permuted view), so that the
        channel-major forward hands cuDNN contiguous OIHW weights with no
        copy a call (the conv kernel's packed weights are built from
        these at the first frame, :func:`..ops.conv3x3.packed_weights`)."""
        for m in self.modules():
            if isinstance(m, Conv):
                k = m.kernel
                oihw = k.new_empty((k.shape[3], k.shape[2], *k.shape[:2]))
                m.kernel = torch.nn.Parameter(oihw.permute(2, 3, 1, 0),
                                              k.requires_grad)
        return super().load_tree(tree)

    def apply(self, params, x):
        p = params.get("params", params)
        if not torch.is_grad_enabled():
            outs = [self._apply_channel_major(p, x[i:i + 1])
                    for i in range(x.shape[0])]
            return outs[0] if len(outs) == 1 else torch.cat(outs)
        RRDBNet.concatenated_blocks += 3 * self.n_blocks * x.shape[0]
        RRDBNet.cudnn_convs += (15 * self.n_blocks + 6) * x.shape[0]
        with span("model.trunk"):
            fea = conv(x, p["Conv_0"])
            body = fea
            for k in range(self.n_blocks):
                body = RRDB.apply(p[f"RRDB_{k}"], body)
            fea = fea + conv(body, p["Conv_1"])
        with span("model.upsample"):
            for i in (2, 3):
                fea = _leaky(conv(upsample_nearest(fea, 2), p[f"Conv_{i}"]))
            return conv(_leaky(conv(fea, p["Conv_4"])), p["Conv_5"])

    def _apply_channel_major(self, p, x):
        """One frame [1, H, W, C] → [1, 4H, 4W, C]: NCHW between the two
        3-channel permutes."""
        with span("model.trunk"):
            fea = _conv_cm(x.permute(0, 3, 1, 2).contiguous(), p["Conv_0"])
            fea = _trunk_buffered(p, fea, self.n_blocks, self.growth)
        with span("model.upsample"):
            for i in (2, 3):
                fea = _conv_tc(F.interpolate(fea, scale_factor=2,
                                             mode="nearest"),
                               p[f"Conv_{i}"], leaky=True)
            fea = _conv_tc(fea, p["Conv_4"], leaky=True)
            return _conv_cm(fea, p["Conv_5"]).permute(0, 2, 3, 1).contiguous()


#: the published names of RRDBNet's top-level convs, in the order of the
#: port's ``Conv_0 .. Conv_5``, in basicsr's and in xinntao's layout
_TOP = {"basicsr": ("conv_first", "conv_body", "conv_up1", "conv_up2",
                    "conv_hr", "conv_last"),
        "xinntao": ("conv_first", "trunk_conv", "upconv1", "upconv2",
                    "HRconv", "conv_last")}
_BODY = {"basicsr": "body.{k}.rdb{j}.conv{i}",
         "xinntao": "RRDB_trunk.{k}.RDB{j}.conv{i}"}


def published_convs(n_blocks=23, features=64, growth=32, channels=3,
                    layout="basicsr"):
    """``[(published name, port path, out, in)]`` of every conv of the
    published RRDBNet in its parameter order: conv_first, the body's
    ``k.rdb1.conv1 .. k.rdb3.conv5`` for each block k, conv_body,
    conv_up1, conv_up2, conv_hr, conv_last."""
    top = _TOP[layout]
    f = features
    out = [(top[0], ("Conv_0",), f, channels)]
    for k in range(n_blocks):
        for j in range(3):
            for i in range(5):
                name = _BODY[layout].format(k=k, j=j + 1, i=i + 1)
                path = (f"RRDB_{k}", f"DenseBlock_{j}", f"Conv_{i}")
                n_out = growth if i < 4 else f
                out.append((name, path, n_out, f + i * growth))
    out += [(top[m], (f"Conv_{m}",), f, f) for m in range(1, 5)]
    out.append((top[5], ("Conv_5",), channels, f))
    return out


def _state_dict_layout(sd: dict) -> str:
    if any(k.startswith(("RRDB_trunk.", "trunk_conv.")) for k in sd):
        return "xinntao"
    return "basicsr"


def tree_from_state_dict(sd: dict, n_blocks=23, features=64, growth=32,
                         channels=3) -> dict:
    """A published RRDBNet state dict (OIHW ``<conv>.weight`` and
    ``<conv>.bias``, basicsr's or xinntao's keys, bare or wrapped in
    ``params_ema`` / ``params``) → the port's ``{"params": ...}`` tree of
    numpy float32 leaves, kernels in HWIO. Raises ValueError on a missing,
    extra or misshapen key."""
    for wrapper in ("params_ema", "params"):
        if isinstance(sd.get(wrapper), dict):
            sd = sd[wrapper]
            break
    layout = _state_dict_layout(sd)
    convs = published_convs(n_blocks, features, growth, channels, layout)
    want = {f"{name}.{leaf}" for name, *_ in convs
            for leaf in ("weight", "bias")}
    missing, extra = sorted(want - set(sd)), sorted(set(sd) - want)
    if missing or extra:
        raise ValueError(f"not an RRDBNet({channels}, {channels}, "
                         f"{features}, {n_blocks}, gc={growth}) state dict "
                         f"({layout} keys): missing {missing[:4]}, extra "
                         f"{extra[:4]}")
    tree: dict = {}
    for name, path, n_out, n_in in convs:
        w = np.asarray(torch.as_tensor(sd[f"{name}.weight"]).cpu(),
                       dtype=np.float32)
        b = np.asarray(torch.as_tensor(sd[f"{name}.bias"]).cpu(),
                       dtype=np.float32)
        if w.shape != (n_out, n_in, 3, 3) or b.shape != (n_out,):
            raise ValueError(f"{name}: weight {w.shape}, bias {b.shape}; "
                             f"expected {(n_out, n_in, 3, 3)}, {(n_out,)}")
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = {"kernel": np.ascontiguousarray(
            w.transpose(2, 3, 1, 0)), "bias": b}
    return {"params": tree}


#: what a seeded ``init`` in ``meta.json`` states, word for word, so that a
#: reader without the port draws the same tensors
INIT_RNG = "numpy.random.default_rng(seed)"
INIT_ORDER = ("conv_first, body.<k>.rdb<j>.conv<i> for k = 0 .. n_blocks - 1, "
              "j = 1 .. 3, i = 1 .. 5, conv_body, conv_up1, conv_up2, "
              "conv_hr, conv_last")
INIT_KERNEL = ("float32(rng.standard_normal((out, in, 3, 3)) * (scale * "
               "sqrt(2 / (9 * in))))")
_INIT_KEYS = {"rng", "seed", "order", "kernel", "scale", "bias"}


def seeded_state_dict(init: dict, n_blocks=23, features=64, growth=32,
                      channels=3) -> dict:
    """The state dict (basicsr keys, OIHW float32 numpy) that a
    ``meta.json`` ``init`` describes: one ``numpy.random.default_rng(seed)``
    draws every kernel in the published parameter order, each as
    ``standard_normal((out, in, 3, 3))`` (float64) times
    ``scale * sqrt(2 / (9 * in))``, cast to float32; ``scale`` is
    ``init["scale"]["body"]`` in the dense blocks and
    ``init["scale"][<name>]`` for the top-level convs. Biases are 0,
    except where ``init["bias"]`` gives a conv's bias."""
    stated = (init.get("rng"), init.get("order"), init.get("kernel"))
    if set(init) - _INIT_KEYS or stated != (INIT_RNG, INIT_ORDER,
                                            INIT_KERNEL):
        raise ValueError(f"init states another draw than this loader's: "
                         f"keys {sorted(init)}, rng, order and kernel "
                         f"{stated}")
    rng = np.random.default_rng(int(init["seed"]))
    bias = init.get("bias", {})
    sd = {}
    for name, _, n_out, n_in in published_convs(n_blocks, features, growth,
                                                channels):
        scale = init["scale"]["body" if name.startswith("body.") else name]
        std = scale * math.sqrt(2.0 / (9 * n_in))
        sd[f"{name}.weight"] = (rng.standard_normal((n_out, n_in, 3, 3))
                                * std).astype(np.float32)
        sd[f"{name}.bias"] = np.asarray(bias.get(name, np.zeros(n_out)),
                                        dtype=np.float32)
    return sd


def load_rrdbnet(model_dir, meta: dict, *, device="cuda"):
    """``(model, params)`` of an RRDBNet checkpoint directory whose
    ``meta.json`` (``meta``) names a published state dict
    (``meta["state_dict"]``, a ``.pth`` beside it, read with
    ``torch.load(weights_only=True)``) or a seeded init (``meta["init"]``,
    :func:`seeded_state_dict`). ``meta`` may give ``features``,
    ``growth`` and ``n_blocks`` (default: the published 64, 32, 23)."""
    dims = {k: int(meta[k]) for k in ("features", "growth", "n_blocks")
            if k in meta}
    if "state_dict" in meta:
        sd = torch.load(pathlib.Path(model_dir) / meta["state_dict"],
                        map_location="cpu", weights_only=True)
    elif "init" in meta:
        sd = seeded_state_dict(meta["init"], **dims)
    else:
        raise ValueError(f"{model_dir}: meta.json names neither a "
                         "state_dict nor an init")
    tree = tree_from_state_dict(sd, **dims)
    model = empty_module(lambda: RRDBNet(scale=int(meta.get("scale", 4)),
                                         **dims), device)
    model.load_tree(tree)
    return model, model.tree()
