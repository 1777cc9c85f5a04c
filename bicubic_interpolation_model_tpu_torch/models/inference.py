"""Learned-model SR inference (counterpart of
``bicubic_interpolation_model_tpu/models/inference.py``).

WeightPredictor checkpoints:

  offsets → model([img/255, offsets]) → 16-tap apply → round-half-even u8.

They take the phase-packed forward (:func:`_super_resolve_packed`): every
tensor stays at LR resolution with the S*S output phases packed into
channels, ``conv_off`` collapses to a per-phase constant and ``conv_out``
is phase-decomposed. On the card its tail (merged map → conv_out → tanh →
apply → round → pack) is one CUDA kernel (:mod:`..ops.packed_tail`), and
RGBA frames can be delivered as RGBA32 words (``layout="hwc32"``) through
the interleave kernel.

Direct-regression checkpoints (ESPCN / ESRGAN / SRResNetTPU,
:data:`.zoo.MODEL_ZOO`) take :func:`super_resolve_direct`: the conv stack
on img/255 and round half up, ``floor(y*255 + 0.5)``. No TPU kernel lies on
that path (the JAX package runs it as XLA convs): here it is cuDNN convs
and plain torch ops.

Functions here run on the device their params lie on. ``compute_dtype``
defaults to float32; bfloat16 is accepted for the model stages (held to the
JAX package's bf16 envelopes) and float64 runs the same function as a
reference. Dense convs go to cuDNN with TF32 off at float32.
"""

from __future__ import annotations

import torch

from ..ops.learned import (_apply_round, _apply_weights_phase, _axis_offsets,
                           _edge_pad_chw, offset_map)
from ..ops.packed_tail import (flat_mats, merged_map_from_mats,
                               packed_phase_tail, packed_tail_fused,
                               packed_tail_supported)
from ..ops.planar import pack_rgba32
from ..runtime.device import conv_precision
from ..utils.profiling import span
from .layers import conv_nhwc, tree_map
from .weight_predictor import forward_params
from .zoo import is_weight_predictor


def param_tree(params) -> dict:
    """The ``{layer: {kernel, bias}}`` dict of a ``{"params": ...}`` tree."""
    return params.get("params", params) if hasattr(params, "get") else params


def _first_leaf(node) -> torch.Tensor:
    while isinstance(node, dict):
        node = next(iter(node.values()))
    return node


def _device_of(p) -> torch.device:
    return _first_leaf(p).device


def _default_dtype(compute_dtype) -> torch.dtype:
    """None → float32; a torch dtype or its name ("bfloat16")."""
    if compute_dtype is None:
        return torch.float32
    if isinstance(compute_dtype, str):
        return getattr(torch, compute_dtype)
    return compute_dtype


def _cast_compute(p: dict, x: torch.Tensor, dtype):
    """Cast float params + activations to the compute dtype."""
    if dtype == torch.float32:
        return p, x
    cast = tree_map(lambda v: v.to(dtype) if v.dtype == torch.float32
                     else v, p)
    return cast, x.to(dtype)


def _as_frames(lr_u8, device) -> torch.Tensor:
    return torch.as_tensor(lr_u8).to(device)


@torch.no_grad()
def predict_weights(model, params, lr_u8, scale: int = 4,
                    convention: str = "inference"):
    """[H_lr, W_lr, C] uint8 → [H_sr, W_sr, 16] predicted weights."""
    p = param_tree(params)
    lr = _as_frames(lr_u8, _device_of(p)).float() / 255.0
    h, w = lr.shape[:2]
    off = offset_map(h * scale, w * scale, float(scale), convention,
                     device=lr.device)
    with conv_precision(torch.float32):
        return forward_params(p, lr[None], off[None])[0]


@torch.no_grad()
def _super_resolve_fused(model, params, lr_u8, scale, convention):
    """The canonical f32 predict → apply → round program at SR resolution
    (``exact=True``)."""
    weights = predict_weights(model, params, lr_u8, scale, convention)
    out = _apply_weights_phase(lr_u8.float(), weights, scale)
    return _apply_round(out).to(torch.uint8)


@torch.no_grad()
def _super_resolve_packed(params, lr_u8, scale, convention,
                          dtype=torch.float32, tail="auto",
                          opaque_alpha=False, layout="hwc",
                          tail_operands=None):
    """The WeightPredictor forward in phase-packed layout, on [h, w, c] or
    [B, h, w, c] uint8 frames.

    ``tail``: "kernel" runs the fused tail wrapper (the CUDA kernel on a
    CUDA tensor, its plain version on a CPU tensor) and raises ValueError
    on a shape it does not take (see ``packed_tail_supported``); "graph"
    runs the plain chain :func:`packed_merged_map` +
    ``ops.packed_tail.packed_phase_tail``; "auto" takes the kernel on CUDA
    tensors of a shape it takes, and the graph otherwise. ``tail_operands``
    are the kernel's :func:`build_tail_operands` for these params and
    convention, built here when not given.
    """
    if tail not in ("auto", "kernel", "graph"):
        raise ValueError(f"tail must be 'auto', 'kernel' or 'graph', got "
                         f"{tail!r}")
    s = int(scale)
    p = param_tree(params)
    single = lr_u8.dim() == 3
    lr = lr_u8[None] if single else lr_u8
    lr_f32 = lr.float()
    bsz, h, w, c = lr.shape
    nw = p["upsample"]["kernel"].shape[2]
    supported = packed_tail_supported(s, 2 * nw, c)
    if tail == "kernel" and not supported:
        raise ValueError(f"tail='kernel' takes S*2F == 128 and c <= 4; got "
                         f"S={s}, 2F={2 * nw}, c={c} (use tail='graph')")
    use_kernel = supported and (tail == "kernel"
                                or (tail == "auto" and lr.is_cuda))
    if use_kernel and tail_operands is None:
        tail_operands = build_tail_operands(p, s, convention)

    p, _ = _cast_compute(p, lr_f32, dtype)
    xf = (lr_f32 / 255.0).to(dtype)
    with conv_precision(dtype):
        y = torch.relu(conv_nhwc(xf, **p["conv_in"]))
        y = y + conv_nhwc(y, **p["conv_res"])             # [B, h, w, F]

    if use_kernel:
        out = packed_tail_fused(
            y.contiguous(), lr_f32, p["conv_out"]["kernel"],
            p["conv_out"]["bias"], *tail_operands, scale=s,
            opaque_alpha=opaque_alpha, layout=layout)
        return out[0] if single else out

    m = packed_merged_map(p, y, s, convention)            # [B,h,w,S,S,2F]
    mp = torch.nn.functional.pad(m, (0, 0, 0, 0, 0, 0, 1, 1, 1, 1))
    out = packed_phase_tail(mp, _edge_pad_chw(lr_f32),
                            p["conv_out"]["kernel"], p["conv_out"]["bias"],
                            s, c, h, w)
    res = _apply_round(out).to(torch.uint8)
    if layout == "hwc32":
        res = pack_rgba32(res)
    return res[0] if single else res


def _packed_off_feat(p, s, convention):
    """The conv_off 1x1 layer collapsed to a per-phase constant [S, S, 16]
    (both offset conventions are periodic in x mod S)."""
    k = p["conv_off"]["kernel"]
    d = _axis_offsets(s * s, float(s), convention, k.device)[:s]
    off_pq = torch.stack([d[None, :].expand(s, s), d[:, None].expand(s, s)],
                         dim=-1).to(k.dtype)
    return off_pq @ k[0, 0] + p["conv_off"]["bias"]


def _packed_upsample_att(p, y):
    """Upsample + attention in packed layout, [B, h, w, F] →
    [B, h, w, S, S, 16] (the einsum oracle for :func:`packed_merged_map`)."""
    up = torch.einsum("byxi,pqoi->byxpqo", y, p["upsample"]["kernel"]) \
        + p["upsample"]["bias"]
    att = torch.sigmoid(
        torch.einsum("byxpqo,oa->byxpqa", up, p["conv_att"]["kernel"][0, 0])
        + p["conv_att"]["bias"])
    return up * att


def build_tail_operands(p, s, convention):
    """The fused tail kernel's operands besides conv_out: kup [F_in,
    S*S*nw] the upsample kernel (lane = phase * nw + o), ubias [nw] its
    bias, offs [S*S, nw] the per-phase offset constant, att_w [nw] and
    att_b [1] the attention conv. Built once per checkpoint by
    ``serving.ModelUpscaler``."""
    ku = p["upsample"]["kernel"]                       # [S, S, nw, F_in]
    nw, n_in = ku.shape[2], ku.shape[3]
    kup = ku.permute(3, 0, 1, 2).reshape(n_in, s * s * nw).contiguous()
    offs = _packed_off_feat(p, s, convention).reshape(s * s, nw)
    return (kup, p["upsample"]["bias"], offs,
            p["conv_att"]["kernel"][0, 0, :, 0], p["conv_att"]["bias"])


def _merged_map_mats(p, s, convention):
    """The flat merged-map matrices (``ops.packed_tail.flat_mats``) for
    params ``p``."""
    return flat_mats(*build_tail_operands(p, s, convention))


def packed_merged_map(p, y, s, convention):
    """Upsample + attention + offset concat → the merged packed map
    [B, h, w, S, S, 2F] of params ``p`` on features ``y`` [B, h, w, F],
    built with flat lane-wide matmuls."""
    return merged_map_from_mats(y, *_merged_map_mats(p, s, convention), s)


def _round_half_up(y: torch.Tensor) -> torch.Tensor:
    """[0, 1] floats → uint8 as the JAX package's direct path rounds them:
    ``clip(floor(y*255 + 0.5), 0, 255)``, half up (not the learned path's
    half-even :func:`_apply_round`)."""
    return torch.floor(y * 255.0 + 0.5).clamp(0, 255).to(torch.uint8)


@torch.no_grad()
def _apply_direct(model, params, x, dtype):
    """The direct model on [B, H, W, C] floats in ``dtype``; the result in
    float32 (float64 for a float64 reference)."""
    p, x = _cast_compute(param_tree(params), x, dtype)
    with conv_precision(dtype):
        y = model.apply(p, x)
    return y.to(torch.promote_types(dtype, torch.float32))


def _direct_frames(model, params, lrs, compute_dtype):
    dt = _default_dtype(compute_dtype)
    x = lrs.to(torch.promote_types(dt, torch.float32)) / 255.0
    return _round_half_up(_apply_direct(model, params, x, dt))


@torch.no_grad()
def super_resolve_direct(model, params, lr_u8, *, compute_dtype=None):
    """Direct-regression SR (ESPCN / ESRGAN / SRResNetTPU families): uint8
    [H, W, C] in (C = the model's input channels, RGB for the committed
    checkpoints), uint8 [H*S, W*S, C] out, on the device the params lie
    on (a numpy frame is moved there).

    ``compute_dtype`` defaults to float32, as in the JAX package, whose
    bf16 gate these conv stacks miss; ``torch.bfloat16`` (or
    "bfloat16") opts in, ``torch.float64`` runs the same function as a
    reference."""
    with span("model.step"):
        lr = _as_frames(lr_u8, _device_of(param_tree(params)))
        return _direct_frames(model, params, lr[None], compute_dtype)[0]


@torch.no_grad()
def super_resolve(model, params, lr_u8, scale: int = 4,
                  convention: str = "inference", *, exact: bool = False,
                  compute_dtype=None, opaque_alpha: bool = False,
                  layout: str = "hwc", tail: str = "auto",
                  tail_operands=None):
    """Full learned SR: uint8 LR [H, W, C] in, uint8 SR out, on the device
    the params lie on (a numpy frame is moved there). A direct-regression
    model goes to :func:`super_resolve_direct` (``scale``, ``convention``,
    ``exact`` and ``tail`` do not apply to it).

    WeightPredictor checkpoints take the phase-packed path; ``exact=True``
    forces the canonical f32 predict+apply program. ``layout="hwc32"``
    (RGBA frames only) returns the same bytes as a [H_sr, W_sr] uint32 word
    array; view it on the host with ``ops.interleave.rgba32_to_hwc_np``.
    ``tail`` selects the packed path's tail and ``tail_operands`` may
    carry its precomputed operands (see :func:`_super_resolve_packed`).
    """
    with span("model.step"):
        p = param_tree(params)
        lr = _as_frames(lr_u8, _device_of(p))
        if layout not in ("hwc", "hwc32"):
            raise ValueError(
                f"layout must be 'hwc' or 'hwc32', got {layout!r}")
        if layout == "hwc32" and lr.shape[-1] != 4:
            raise ValueError("layout='hwc32' packs 4 channel bytes per "
                             f"word; got C={lr.shape[-1]} (RGBA frames "
                             "only)")
        if not is_weight_predictor(model, p):
            if layout != "hwc":
                raise ValueError(f"{type(model).__name__} returns RGB "
                                 "frames; layout='hwc32' is for RGBA "
                                 "WeightPredictor output")
            return _direct_frames(model, params, lr[None], compute_dtype)[0]
        if not exact:
            return _super_resolve_packed(
                params, lr, int(scale), convention,
                dtype=_default_dtype(compute_dtype), tail=tail,
                opaque_alpha=opaque_alpha, layout=layout,
                tail_operands=tail_operands)
        out = _super_resolve_fused(model, params, lr, int(scale), convention)
        # RGBA32 words as a byte view of the same device memory: no host
        # trip
        return pack_rgba32(out) if layout == "hwc32" else out


@torch.no_grad()
def super_resolve_batch(model, params, lrs_u8, scale: int = 4,
                        convention: str = "inference", *,
                        exact: bool = False, compute_dtype=None,
                        opaque_alpha: bool = False, tail: str = "auto",
                        tail_operands=None):
    """[B, H, W, C] same-size frames in one launch: the batch is the fused
    tail kernel's leading grid dimension, or the convs' batch for a
    direct-regression model. Same numerics contracts as
    :func:`super_resolve` / :func:`super_resolve_direct`; returns uint8
    [B, H_sr, W_sr, C]."""
    with span("model.step"):
        p = param_tree(params)
        lrs = _as_frames(lrs_u8, _device_of(p))
        if lrs.dim() != 4:
            raise ValueError("expected [B, H, W, C] uint8")
        if not is_weight_predictor(model, p):
            return _direct_frames(model, params, lrs, compute_dtype)
        if not exact:
            return _super_resolve_packed(
                params, lrs, int(scale), convention,
                dtype=_default_dtype(compute_dtype), tail=tail,
                opaque_alpha=opaque_alpha, tail_operands=tail_operands)
        return torch.stack([_super_resolve_fused(model, params, im,
                                                 int(scale), convention)
                            for im in lrs])
