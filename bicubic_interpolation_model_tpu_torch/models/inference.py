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
:data:`.espcn.MODEL_ZOO`) take :func:`super_resolve_direct`: the conv stack
on img/255 and round half up, ``floor(y*255 + 0.5)``. No TPU kernel lies on
that path (the JAX package runs it as XLA convs): here it is cuDNN convs
and plain torch ops.

Functions here run on the device their params lie on. ``compute_dtype``
defaults to float32; bfloat16 is accepted for the model stages (held to the
JAX package's bf16 envelopes) and float64 runs the same function as a
reference. Dense convs go to cuDNN with TF32 off at float32.
"""

from __future__ import annotations

import contextlib

import torch

from ..ops.learned import (_apply_round, _apply_weights_phase, _axis_offsets,
                           _edge_pad_chw, offset_map)
from ..ops.packed_tail import packed_tail_fused, packed_tail_supported
from ..ops.planar import pack_rgba32
from ..utils.profiling import span
from .layers import conv_nhwc, tree_map
from .weight_predictor import LAYERS, forward_params


def _tree(params) -> dict:
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


def _conv_precision(dtype):
    """Full-f32 cuDNN convs at float32 (cuDNN defaults to TF32) for this
    region only; the global flag is left alone."""
    if dtype == torch.float32:
        return torch.backends.cudnn.flags(enabled=True, allow_tf32=False)
    return contextlib.nullcontext()


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
    p = _tree(params)
    lr = _as_frames(lr_u8, _device_of(p)).float() / 255.0
    h, w = lr.shape[:2]
    off = offset_map(h * scale, w * scale, float(scale), convention,
                     device=lr.device)
    with _conv_precision(torch.float32):
        return forward_params(p, lr[None], off[None])[0]


@torch.no_grad()
def _super_resolve_fused(model, params, lr_u8, scale, convention):
    """The canonical f32 predict → apply → round program at SR resolution
    (``exact=True``)."""
    p = _tree(params)
    lr_f32 = lr_u8.float()
    h, w = lr_f32.shape[:2]
    off = offset_map(h * scale, w * scale, float(scale), convention,
                     device=lr_f32.device)
    with _conv_precision(torch.float32):
        weights = forward_params(p, (lr_f32 / 255.0)[None], off[None])[0]
    out = _apply_weights_phase(lr_f32, weights, scale)
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
    runs the plain chain :func:`_packed_merged_map` +
    :func:`_packed_phase_tail`; "auto" takes the kernel on CUDA tensors of
    a shape it takes, and the graph otherwise. ``tail_operands`` are the
    kernel's :func:`_tail_operands` for these params and convention,
    built here when not given.
    """
    if tail not in ("auto", "kernel", "graph"):
        raise ValueError(f"tail must be 'auto', 'kernel' or 'graph', got "
                         f"{tail!r}")
    s = int(scale)
    p = _tree(params)
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
        tail_operands = _tail_operands(p, s, convention)

    p, _ = _cast_compute(p, lr_f32, dtype)
    xf = (lr_f32 / 255.0).to(dtype)
    with _conv_precision(dtype):
        y = torch.relu(conv_nhwc(xf, **p["conv_in"]))
        y = y + conv_nhwc(y, **p["conv_res"])             # [B, h, w, F]

    if use_kernel:
        out = packed_tail_fused(
            y.contiguous(), lr_f32, p["conv_out"]["kernel"],
            p["conv_out"]["bias"], *tail_operands, scale=s,
            opaque_alpha=opaque_alpha, layout=layout)
        return out[0] if single else out

    m = _packed_merged_map(p, y, s, convention)           # [B,h,w,S,S,2F]
    mp = torch.nn.functional.pad(m, (0, 0, 0, 0, 0, 0, 1, 1, 1, 1))
    out = _packed_phase_tail(mp, _edge_pad_chw(lr_f32),
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
    [B, h, w, S, S, 16] (the einsum oracle for :func:`_packed_merged_map`)."""
    up = torch.einsum("byxi,pqoi->byxpqo", y, p["upsample"]["kernel"]) \
        + p["upsample"]["bias"]
    att = torch.sigmoid(
        torch.einsum("byxpqo,oa->byxpqa", up, p["conv_att"]["kernel"][0, 0])
        + p["conv_att"]["bias"])
    return up * att


def _tail_operands(p, s, convention):
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


def _flat_mats(kup, ubias, offs, att_w, att_b):
    """The flat merged-map matrices from the tail operands: kflat [F_in,
    S*S*2F] scattered upsample kernel (offset lanes zero), bias [S*S*2F]
    upsample bias + per-phase offset constant, amat [S*S*2F, S*S]
    block-diagonal attention contraction, abias [1]."""
    blocks, nw = offs.shape
    n_in = kup.shape[0]
    kflat = torch.cat([kup.reshape(n_in, blocks, nw),
                       torch.zeros_like(kup).reshape(n_in, blocks, nw)],
                      dim=-1).reshape(n_in, blocks * 2 * nw)
    bias = torch.cat([ubias.expand(blocks, nw), offs], dim=-1).reshape(-1)
    col = torch.cat([att_w, torch.zeros_like(att_w)])
    amat = torch.kron(torch.eye(blocks, dtype=col.dtype, device=col.device),
                      col[:, None])
    return kflat, bias, amat, att_b


def _merged_map_mats(p, s, convention):
    """The flat merged-map matrices of :func:`_flat_mats` for params ``p``."""
    return _flat_mats(*_tail_operands(p, s, convention))


def _merged_map_from_mats(y, kflat, bias, amat, abias, s, *, rq=None):
    """Merged packed map [B, h, w, S, S, 2F] from features [B, h, w, F]
    and the flat matrices: one [M, F] @ [F, S*S*2F] product, attention
    against the block-diagonal matrix, the gate on up-lanes only.

    ``rq`` (f32 features only) rounds the stages where the fused kernel
    rounds them in bf16 mode: the pre-gate map before the attention
    product, the attention before the gate, the gated map."""
    blocks = s * s
    twof = kflat.shape[-1] // blocks
    nw = twof // 2
    rq = rq or (lambda t: t)
    m_pre = torch.einsum("byxi,ij->byxj", y, kflat.to(y.dtype)) \
        + bias.to(y.dtype)
    att = rq(torch.sigmoid(torch.einsum("nyxj,jk->nyxk", rq(m_pre),
                                        amat.to(y.dtype))
                           + abias.to(y.dtype)))
    lane_is_up = (torch.arange(blocks * twof, device=y.device) % twof) < nw
    gate = torch.where(lane_is_up, att.repeat_interleave(twof, dim=-1),
                       torch.ones((), dtype=att.dtype, device=y.device))
    return rq(m_pre * gate).reshape(y.shape[:3] + (s, s, twof))


def _packed_merged_map(p, y, s, convention):
    """Upsample + attention + offset concat → the merged packed map
    [B, h, w, S, S, 2F], built with flat lane-wide matmuls."""
    return _merged_map_from_mats(y, *_merged_map_mats(p, s, convention), s)


def _packed_phase_tail(mp, chw, kout, bout, s, c, h, w, *,
                       opaque_alpha=False):
    """conv_out (phase-decomposed 3x3, tanh) + the 16-tap apply per phase
    plane. ``mp`` is the merged packed map with one zero row/col of padding
    on each side ([B, h+2, w+2, S, S, 2F]); ``chw`` the planar LR pixels,
    edge-padded (1 leading, 2 trailing) ([B, C, h+3, w+3]). With
    ``opaque_alpha`` (c = 4) alpha is 255 * sum(w) instead of the 16-tap
    sum. Returns float [B, h*S, w*S, c]."""
    kout = kout.to(mp.dtype)
    n_ch = 3 if opaque_alpha and c == 4 else c
    cols = []
    for pp in range(s):
        planes = []
        for q in range(s):
            acc = None
            for dy in (-1, 0, 1):
                p2, sy = (pp + dy) % s, (pp + dy) // s
                for dx in (-1, 0, 1):
                    q2, sx = (q + dx) % s, (q + dx) // s
                    src = mp[:, 1 + sy:1 + sy + h, 1 + sx:1 + sx + w, p2, q2]
                    t = torch.einsum("bhwi,io->bhwo", src,
                                     kout[dy + 1, dx + 1])
                    acc = t if acc is None else acc + t
            wts = torch.tanh((acc + bout.to(acc.dtype)).float())  # [B,h,w,16]
            aw = None
            for i in range(16):
                ty, tx = i // 4, i % 4
                term = wts[:, None, :, :, i] * chw[:, :n_ch, ty:ty + h,
                                                   tx:tx + w]
                aw = term if aw is None else aw + term
            if n_ch < c:
                alpha = wts.sum(dim=-1)[:, None] * 255.0
                aw = torch.cat([aw, alpha], dim=1)
            planes.append(aw)                              # [B, C, h, w]
        cols.append(torch.stack(planes, dim=-1))           # [B, C, h, w, S]
    grid = torch.stack(cols, dim=3)                        # [B, C, h, S, w, S]
    bsz = mp.shape[0]
    return grid.permute(0, 2, 3, 4, 5, 1).reshape(bsz, h * s, w * s, c)


def _is_weight_predictor(model, p) -> bool:
    return (type(model).__name__ == "WeightPredictor"
            and all(k in p for k in LAYERS))


def _round_half_up(y: torch.Tensor) -> torch.Tensor:
    """[0, 1] floats → uint8 as the JAX package's direct path rounds them:
    ``clip(floor(y*255 + 0.5), 0, 255)``, half up (not the learned path's
    half-even :func:`_apply_round`)."""
    return torch.floor(y * 255.0 + 0.5).clamp(0, 255).to(torch.uint8)


@torch.no_grad()
def _apply_direct(model, params, x, dtype):
    """The direct model on [B, H, W, C] floats in ``dtype``; the result in
    float32 (float64 for a float64 reference)."""
    p, x = _cast_compute(_tree(params), x, dtype)
    with _conv_precision(dtype):
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
        lr = _as_frames(lr_u8, _device_of(_tree(params)))
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
        p = _tree(params)
        lr = _as_frames(lr_u8, _device_of(p))
        if layout not in ("hwc", "hwc32"):
            raise ValueError(
                f"layout must be 'hwc' or 'hwc32', got {layout!r}")
        if layout == "hwc32" and lr.shape[-1] != 4:
            raise ValueError("layout='hwc32' packs 4 channel bytes per "
                             f"word; got C={lr.shape[-1]} (RGBA frames "
                             "only)")
        if type(model).__name__ != "WeightPredictor":
            if layout != "hwc":
                raise ValueError(f"{type(model).__name__} returns RGB "
                                 "frames; layout='hwc32' is for RGBA "
                                 "WeightPredictor output")
            return _direct_frames(model, params, lr[None], compute_dtype)[0]
        if not exact and _is_weight_predictor(model, p):
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
        p = _tree(params)
        lrs = _as_frames(lrs_u8, _device_of(p))
        if lrs.dim() != 4:
            raise ValueError("expected [B, H, W, C] uint8")
        if type(model).__name__ != "WeightPredictor":
            return _direct_frames(model, params, lrs, compute_dtype)
        if not exact and _is_weight_predictor(model, p):
            return _super_resolve_packed(
                params, lrs, int(scale), convention,
                dtype=_default_dtype(compute_dtype), tail=tail,
                opaque_alpha=opaque_alpha, tail_operands=tail_operands)
        return torch.stack([_super_resolve_fused(model, params, im,
                                                 int(scale), convention)
                            for im in lrs])
