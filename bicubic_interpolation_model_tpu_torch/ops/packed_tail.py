"""Packed tail of the WeightPredictor forward (CUDA kernels A and G).

:func:`packed_tail_fused` (kernel A, ``csrc/packed_tail.cu``): from the
conv_in/conv_res features, one pass computes the phase-packed merged map
(upsample + per-phase offset constant + sigmoid attention gate), the
phase-decomposed 3x3 ``conv_out``, tanh, the 16-tap apply over each LR 4x4
neighbourhood, round-half-even and u8 channel packing. The merged map (363
MB in f32 at a 348x510 frame) never reaches device memory. Its plain PyTorch
version, :func:`packed_tail_fused_reference`, is the graph chain of this
module: :func:`merged_map_from_mats` on :func:`flat_mats`, then
:func:`packed_phase_tail`, round and pack.

:func:`packed_tail` (kernel G, ``csrc/packed_tail_map.cu``): the same tail
fed a precomputed merged map, with single-frame zero padding
(``halo="zero"``) or the real neighbour rows of a band
(``halo="rows"``, the band-sharded learned path). Its plain version is
:func:`packed_tail_reference`.

Both kernels run their matrix products (conv_out, and A's upsample) on the
tensor cores through ``csrc/tail_mma.cuh``: 3xTF32 for f32 inputs, one bf16
pass with f32 accumulation for bf16 inputs.

Counterparts of ``bicubic_interpolation_model_tpu/ops/pallas_packed_tail.py``
(``packed_tail_fused``, ``packed_tail_pallas``).

:func:`packed_tail_probe` launches kernel G's stage probes: the same grid,
ring, products and stores with the stages after conv_out's products cut
back to front, each writing a reduction of its last live stage
(``"matmul"``, ``"tanh"``, ``"apply"``; the TPU lab's ``relayout`` stage
is ``"tanh"`` here, since kernel G's apply reads the weights in the
products' own layout), for dividing the kernel's time between its stages
(``bench/labs.py``). Their plain version is
:func:`packed_tail_probe_reference`.

Output layouts: ``"planar"`` is the kernel's ``[S, h*S, w]`` uint32 (column
phase planar, row phases interleaved, channel bytes little-endian; unpadded);
``"hwc"`` is uint8 ``[h*S, w*S, c]``; ``"hwc32"`` the RGBA32 word array
``[h*S, w*S]`` through kernel B (:mod:`.interleave`).
"""

from __future__ import annotations

import ctypes

import torch

from ..runtime import build
from .interleave import interleave_planar_u32
from .learned import _apply_round, _edge_pad_chw
from .planar import pack_rgba32, unpack_planar

_F_IN = 32              # the kernel's conv feature width (WeightPredictor)
_N_OUT = 16             # conv_out channels = predicted weights
#: kernel G's stage probes and their ids in csrc/packed_tail_map.cu
PROBES = {"matmul": 1, "tanh": 2, "apply": 3}


def packed_tail_supported(scale: int, twof: int, c: int) -> bool:
    """The packed tail covers the WeightPredictor family: S*2F == 128
    (S=4, 2F=32) and channels that pack into one u32 word (c <= 4)."""
    return int(scale) * twof == 128 and 1 <= c <= 4


def fused_tail_grid(batch: int, h: int, w: int,
                    device: torch.device | str = "cuda") -> tuple[int, int]:
    """Kernel A's persistent grid for ``batch`` frames of h x w on a CUDA
    ``device``, as its launch decides it: (tiles of the batch, blocks
    launched). The launch runs one block per SM, or one per tile where
    there are fewer, and block i walks tiles i, i + blocks, ...; each tile
    after a block's first has its inputs loaded during the previous tile's
    conv_out (tiles - blocks of them). Builds the kernel library."""
    tiles, blocks = ctypes.c_longlong(), ctypes.c_int()
    with torch.cuda.device(device):
        rc = build.library().bim_packed_tail_fused_grid(
            batch, h, w, ctypes.byref(tiles), ctypes.byref(blocks))
    build.check(rc, "packed_tail_fused_grid")
    return tiles.value, blocks.value


# -- the plain tail math: the graph chain the kernels are held to ----------

def flat_mats(kup, ubias, offs, att_w, att_b):
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


def merged_map_from_mats(y, kflat, bias, amat, abias, s, *, rq=None):
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


def _phase_conv_out(mp, kout, pp, q, s, h, w):
    """conv_out's 3x3 sums (no bias) [B, h, w, 16] at output phase (pp, q),
    read from the neighbouring phases of the padded map ``mp``."""
    acc = None
    for dy in (-1, 0, 1):
        p2, sy = (pp + dy) % s, (pp + dy) // s
        for dx in (-1, 0, 1):
            q2, sx = (q + dx) % s, (q + dx) // s
            src = mp[:, 1 + sy:1 + sy + h, 1 + sx:1 + sx + w, p2, q2]
            t = torch.einsum("bhwi,io->bhwo", src, kout[dy + 1, dx + 1])
            acc = t if acc is None else acc + t
    return acc


def packed_phase_tail(mp, chw, kout, bout, s, c, h, w, *,
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
            acc = _phase_conv_out(mp, kout, pp, q, s, h, w)
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


def packed_tail_fused_reference(y, lr_f32, kout, bout, kup, ubias, offs,
                                att_w, att_b, *, scale: int = 4,
                                opaque_alpha: bool = False) -> torch.Tensor:
    """The plain PyTorch version of the kernel: [B, h, w, F] features and
    [B, h, w, c] pixels → [B, S, h*S, w] planar uint32.

    The graph chain on the flat merged-map matrices built from the same
    operands. f32 features take it as it is. bf16 features compute in f32
    on bf16-rounded operands and round the merged-map stages where the
    kernel does (as the TPU kernel: bf16 operands, f32 accumulation)."""
    s = int(scale)
    bsz, h, w, _ = y.shape
    c = lr_f32.shape[-1]
    ops = [t.float() for t in (kup, ubias, offs, att_w, att_b)]
    rq = None
    if y.dtype == torch.bfloat16:
        rq = lambda t: t.to(torch.bfloat16).float()
        y, kout = y.float(), rq(kout.float())
        ops[0], ops[3] = rq(ops[0]), rq(ops[3])
    m = merged_map_from_mats(y, *flat_mats(*ops), s, rq=rq)
    mp = torch.nn.functional.pad(m, (0, 0, 0, 0, 0, 0, 1, 1, 1, 1))
    out = packed_phase_tail(mp, _edge_pad_chw(lr_f32), kout, bout, s, c, h,
                            w, opaque_alpha=opaque_alpha and c == 4)
    words = pack_rgba32(_apply_round(out).to(torch.uint8))   # [B, hS, wS]
    return words.reshape(bsz, h * s, w, s).permute(0, 3, 1, 2).contiguous()


def _check(y, lr_f32, kout, bout, kup, ubias, offs, att_w, att_b, s):
    if y.dim() != 4 or lr_f32.dim() != 4 or y.shape[:3] != lr_f32.shape[:3]:
        raise ValueError("packed_tail_fused expects y [B,h,w,F] and lr "
                         f"[B,h,w,c]; got {tuple(y.shape)}, "
                         f"{tuple(lr_f32.shape)}")
    twof = 2 * (kup.shape[-1] // (s * s))
    if not packed_tail_supported(s, twof, lr_f32.shape[-1]):
        raise ValueError(f"packed tail needs S*2F==128, c<=4; got S={s}, "
                         f"2F={twof}, c={lr_f32.shape[-1]}")
    if y.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"features must be float32 or bfloat16, got "
                         f"{y.dtype}")
    shapes = {"y": (y, (y.shape[0], y.shape[1], y.shape[2], _F_IN)),
              "kout": (kout, (3, 3, twof, _N_OUT)), "bout": (bout, (_N_OUT,)),
              "kup": (kup, (_F_IN, s * s * _N_OUT)),
              "ubias": (ubias, (_N_OUT,)), "offs": (offs, (s * s, _N_OUT)),
              "att_w": (att_w, (_N_OUT,)), "att_b": (att_b, (1,))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got "
                             f"{tuple(t.shape)}")
    devs = {t.device for t in (y, lr_f32, kout, bout, kup, ubias, offs,
                               att_w, att_b)}
    if len(devs) != 1:
        raise ValueError(f"packed_tail_fused inputs on several devices: "
                         f"{devs}")


def _launch(y, lr_f32, kout, bout, kup, ubias, offs, att_w, att_b, s,
            opaque_alpha):
    bsz, h, w, _ = y.shape
    c = lr_f32.shape[-1]
    bf16 = y.dtype == torch.bfloat16
    # the kernel reads f32 parameters; in bf16 mode the matmul operands
    # arrive rounded to bf16, as the TPU kernel casts them
    rnd = ((lambda t: t.to(torch.bfloat16).float()) if bf16
           else (lambda t: t))
    params = [rnd(kout.float()).contiguous(), bout.float().contiguous(),
              rnd(kup.float()).contiguous(), ubias.float().contiguous(),
              rnd(offs.float()).contiguous(), rnd(att_w.float()).contiguous(),
              att_b.float().contiguous()]
    y = y.contiguous()
    if y.data_ptr() % 16:           # the kernel copies 16 bytes at a time
        y = y.clone()
    lr = lr_f32.float().contiguous()
    out = torch.empty((bsz, s, h * s, w), dtype=torch.uint32, device=y.device)
    if out.numel():
        lib = build.library()
        with torch.cuda.device(y.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc = lib.bim_packed_tail_fused(
                y.data_ptr(), int(bf16), lr.data_ptr(),
                *[t.data_ptr() for t in params], out.data_ptr(),
                bsz, h, w, c, int(opaque_alpha), stream)
        build.check(rc, "packed_tail_fused")
        tiles, blocks = fused_tail_grid(bsz, h, w, y.device)
        packed_tail_fused.launches += 1
        packed_tail_fused.tiles += tiles
        packed_tail_fused.blocks += blocks
    return out


def packed_tail_fused(y, lr_f32, kout, bout, kup, ubias, offs, att_w, att_b,
                      *,
                      scale: int = 4, layout: str = "hwc",
                      opaque_alpha: bool = False):
    """Fused-upstream packed tail: conv features in, u8 pixels out.

    y:      [h, w, 32] (or [B, h, w, 32]) conv_in/conv_res output, float32
            or bfloat16 (bf16 rounds the merged-map stages like the TPU
            kernel; accumulation is f32)
    lr_f32: [h, w, c] (or [B, h, w, c]) LR pixels as float (0..255), c <= 4
    kout:   [3, 3, 32, 16] conv_out kernel;  bout: [16] bias
    kup, ubias, offs, att_w, att_b: the merged map's operands
            (``models.inference.build_tail_operands``: upsample kernel
            [32, 256] and bias [16], per-phase offset constants [16, 16],
            attention vector [16] and bias [1]); the JAX kernel takes
            them as the flat matrices of :func:`flat_mats`
    layout: "hwc" (uint8 [.., h*S, w*S, c]), "hwc32" (uint32 RGBA32 words
            [.., h*S, w*S]) or "planar" (uint32 [.., S, h*S, w]).

    On CUDA tensors this launches the kernel (or raises); on CPU tensors it
    runs :func:`packed_tail_fused_reference`.
    """
    if layout not in ("hwc", "hwc32", "planar"):
        raise ValueError(f"unknown layout {layout!r}")
    s = int(scale)
    single = y.dim() == 3
    if single:
        y, lr_f32 = y[None], lr_f32[None]
    args = (y, lr_f32, kout, bout, kup, ubias, offs, att_w, att_b)
    _check(*args, s)
    if y.device.type == "cpu":
        planar = packed_tail_fused_reference(*args, scale=s,
                                             opaque_alpha=opaque_alpha)
    elif y.device.type == "cuda":
        planar = _launch(*args, s, opaque_alpha)
    else:
        raise ValueError(f"unsupported device {y.device}")
    _, h, w, c = lr_f32.shape
    if layout == "planar":
        out = planar
    elif layout == "hwc32":
        if c != 4:
            raise ValueError("layout='hwc32' needs c == 4")
        if single:
            return interleave_planar_u32(planar[0])
        out = torch.stack([interleave_planar_u32(f) for f in planar])
    else:
        out = unpack_planar(planar, h, w, s, c)
    return out[0] if single else out


packed_tail_fused.launches = 0
#: tiles computed and blocks launched over the card launches: the launch
#: runs ``fused_tail_grid``'s blocks, one per SM where the tiles outnumber
#: the SMs, and tiles - blocks of the tiles had their inputs prefetched
packed_tail_fused.tiles = 0
packed_tail_fused.blocks = 0


def _padded_map(m, halo):
    """A merged map [rows, w, S, S, 2F] padded as kernel G reads it:
    ``halo="zero"`` one zero row and column on each side, ``"rows"``
    columns only (the caller's rows are real); with the frame's rows and
    the rows of padding that lead it."""
    rows = m.shape[0]
    h, lead = (rows - 2, 0) if halo == "rows" else (rows, 1)
    pad = (0, 0, 0, 0, 0, 0, 1, 1, lead, lead)
    return torch.nn.functional.pad(m, pad), h, lead


def packed_tail_reference(m, lr_f32, kout, bout, *, scale: int = 4,
                          opaque_alpha: bool = False,
                          halo: str = "zero") -> torch.Tensor:
    """The plain PyTorch version of kernel G: merged map [h(+2), w, S, S,
    2F] and LR pixels [h(+3), w, c] → planar uint32 [S, h*S, w].

    The graph chain :func:`packed_phase_tail` + round + pack on the map
    padded as the kernel reads it (:func:`_padded_map`) and the LR
    edge-padded (1 leading, 2 trailing; columns only for ``halo="rows"``).
    A bf16 map computes in f32 on the map's values and on ``kout`` rounded
    to bf16 (the TPU kernel's matmuls: bf16 operands, f32 accumulation)."""
    s = int(scale)
    if m.dtype == torch.bfloat16:
        m, kout = m.float(), kout.to(torch.bfloat16)
    mp, h, lead = _padded_map(m, halo)
    w, c = m.shape[1], lr_f32.shape[-1]
    chw = torch.nn.functional.pad(lr_f32.float().movedim(-1, 0)[None],
                                  (1, 2, lead, 2 * lead), mode="replicate")
    out = packed_phase_tail(mp[None], chw, kout.float(), bout.float(), s, c,
                            h, w, opaque_alpha=opaque_alpha and c == 4)[0]
    words = pack_rgba32(_apply_round(out).to(torch.uint8))      # [hS, wS]
    return words.reshape(h * s, w, s).permute(2, 0, 1).contiguous()


def packed_tail_probe_reference(m, lr_f32, kout, bout, probe: str, *,
                                scale: int = 4, halo: str = "zero"):
    """The plain version of kernel G's stage probes on the operands of
    :func:`packed_tail_reference`, planar ``[S, h*S, w]``: ``"matmul"`` the
    sum of a pixel's 16 conv_out values (bias included) and ``"tanh"`` the
    sum of their tanh, float32; ``"apply"`` channel 0 of
    :func:`packed_tail_reference`, uint32 (the other bytes 0)."""
    if probe not in PROBES:
        raise ValueError(f"unknown probe {probe!r}")
    s = int(scale)
    if probe == "apply":
        words = packed_tail_reference(m, lr_f32, kout, bout, scale=s,
                                      halo=halo)
        return (words.view(torch.int32) & 0xff).view(torch.uint32)
    if m.dtype == torch.bfloat16:
        m, kout = m.float(), kout.to(torch.bfloat16)
    kout, bout = kout.float(), bout.float()
    mp, h, _ = _padded_map(m.float(), halo)
    w = m.shape[1]
    out = torch.empty((s, h * s, w), dtype=torch.float32, device=m.device)
    for pp in range(s):
        for q in range(s):
            wts = _phase_conv_out(mp[None], kout, pp, q, s, h, w)[0] + bout
            if probe != "matmul":
                wts = torch.tanh(wts)
            out[q, pp::s] = wts.sum(dim=-1)
    return out


def packed_tail_probe(m, lr_f32, kout, bout, probe: str, *,
                      scale: int = 4, halo: str = "zero"):
    """A stage probe of kernel G (``PROBES``; module docstring) on the
    operands of :func:`packed_tail` (no opaque alpha), planar ``[S, h*S,
    w]``: float32 sums for ``"matmul"`` and ``"tanh"``, uint32 words for
    ``"apply"``. CUDA tensors launch the probe instance,
    CPU tensors run :func:`packed_tail_probe_reference`. Launches are
    counted per probe name and map type in ``packed_tail_probe.launches``
    (``"tanh_f32"``, ...)."""
    if probe not in PROBES:
        raise ValueError(f"unknown probe {probe!r}")
    s = int(scale)
    if m.dim() == 6 and m.shape[0] == 1:
        m = m[0]
    h = _check_map(m, lr_f32, kout, bout, s, halo)
    if m.device.type == "cpu":
        return packed_tail_probe_reference(m, lr_f32, kout, bout, probe,
                                           scale=s, halo=halo)
    if m.device.type != "cuda":
        raise ValueError(f"unsupported device {m.device}")
    return _launch_map(m, lr_f32, kout, bout, h, s, False, halo, probe)


packed_tail_probe.launches = dict.fromkeys(
    [f"{p}_{d}" for d in ("f32", "bf16") for p in PROBES], 0)


def _check_map(m, lr_f32, kout, bout, s, halo):
    if halo not in ("zero", "rows"):
        raise ValueError(f"halo must be 'zero' or 'rows', got {halo!r}")
    if m.dim() != 5 or lr_f32.dim() != 3:
        raise ValueError("packed_tail expects m [h, w, S, S, 2F] and lr "
                         f"[h, w, c]; got {tuple(m.shape)}, "
                         f"{tuple(lr_f32.shape)}")
    twof = m.shape[-1]
    if not packed_tail_supported(s, twof, lr_f32.shape[-1]):
        raise ValueError(f"packed tail needs S*2F==128, c<=4; got S={s}, "
                         f"2F={twof}, c={lr_f32.shape[-1]}")
    h = m.shape[0] - 2 if halo == "rows" else m.shape[0]
    lr_rows = h + 3 if halo == "rows" else h
    if halo == "rows" and lr_f32.shape[0] != lr_rows:
        raise ValueError(f"halo='rows' expects lr rows == h+3 ({lr_rows}), "
                         f"got {lr_f32.shape[0]}")
    if tuple(m.shape[2:4]) != (s, s) or h < 0 or tuple(
            lr_f32.shape[:2]) != (lr_rows, m.shape[1]):
        raise ValueError(f"m {tuple(m.shape)} and lr {tuple(lr_f32.shape)} "
                         f"do not describe one {h}-row frame at scale {s}")
    if m.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the merged map must be float32 or bfloat16, got "
                         f"{m.dtype}")
    for name, t, shape in (("kout", kout, (3, 3, twof, _N_OUT)),
                           ("bout", bout, (_N_OUT,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got "
                             f"{tuple(t.shape)}")
    devs = {t.device for t in (m, lr_f32, kout, bout)}
    if len(devs) != 1:
        raise ValueError(f"packed_tail inputs on several devices: {devs}")
    return h


def _launch_map(m, lr_f32, kout, bout, h, s, opaque_alpha, halo,
                probe="full"):
    w, c = m.shape[1], lr_f32.shape[-1]
    bf16 = m.dtype == torch.bfloat16
    m = m.contiguous()
    if m.data_ptr() % 16:           # the kernel reads 16 bytes at a time
        m = m.clone()
    kout = (kout.to(torch.bfloat16) if bf16 else kout).float().contiguous()
    bout = bout.float().contiguous()
    lr = lr_f32.float().contiguous()
    sums = probe in ("matmul", "tanh")      # f32 bits per word
    out = torch.empty((s, h * s, w), device=m.device,
                      dtype=torch.float32 if sums else torch.uint32)
    if out.numel():
        lib = build.library()
        args = (m.data_ptr(), int(bf16), lr.data_ptr(), kout.data_ptr(),
                bout.data_ptr(), out.data_ptr(), h, w, c,
                int(halo == "rows"))
        with torch.cuda.device(m.device):
            stream = torch.cuda.current_stream().cuda_stream
            if probe == "full":
                rc = lib.bim_packed_tail_map(*args, int(opaque_alpha),
                                             stream)
            else:
                rc = lib.bim_packed_tail_map_probe(*args, PROBES[probe],
                                                   stream)
        if probe == "full":
            build.check(rc, "packed_tail")
            packed_tail.launches += 1
        else:
            build.check(rc, f"packed_tail probe {probe}")
            packed_tail_probe.launches[
                f"{probe}_{'bf16' if bf16 else 'f32'}"] += 1
    return out


def packed_tail(m, lr_f32, kout, bout, *, scale: int = 4,
                layout: str = "hwc", opaque_alpha: bool = False,
                halo: str = "zero"):
    """conv_out + tanh + 16-tap apply + round on a precomputed merged map.

    m:      [h, w, S, S, 2F] merged packed map (attended upsample features
            and the per-phase offset constant; a leading batch of one is
            dropped), float32 or bfloat16 (bf16 rounds ``kout`` to bf16 and
            accumulates in f32, as the TPU kernel's matmuls run in m.dtype)
    lr_f32: [h, w, c] LR pixels as float (0..255), c <= 4
    kout:   [3, 3, 2F, 16] conv_out kernel;  bout: [16] bias
    halo:   "zero": one frame, the map is zero and the LR clamped outside
            it. "rows": a band of the band-sharded path, whose caller passes
            real neighbour rows: m spans band rows [-1, h+1) ([h+2, w, ...])
            and lr_f32 [-1, h+2) ([h+3, w, c]); only columns are padded.
    layout: "hwc" (uint8 [h*S, w*S, c]), "hwc32" (uint32 RGBA32 words
            [h*S, w*S] through kernel B) or "planar" (uint32 [S, h*S, w]).

    On CUDA tensors this launches kernel G (or raises); on CPU tensors it
    runs :func:`packed_tail_reference`.
    """
    if layout not in ("hwc", "hwc32", "planar"):
        raise ValueError(f"unknown layout {layout!r}")
    s = int(scale)
    if m.dim() == 6 and m.shape[0] == 1:
        m = m[0]
    h = _check_map(m, lr_f32, kout, bout, s, halo)
    if m.device.type == "cpu":
        planar = packed_tail_reference(m, lr_f32, kout, bout, scale=s,
                                       opaque_alpha=opaque_alpha, halo=halo)
    elif m.device.type == "cuda":
        planar = _launch_map(m, lr_f32, kout, bout, h, s,
                             opaque_alpha and lr_f32.shape[-1] == 4, halo)
    else:
        raise ValueError(f"unsupported device {m.device}")
    if layout == "planar":
        return planar
    if layout == "hwc32":
        return interleave_planar_u32(planar)
    return unpack_planar(planar, h, m.shape[1], s, lr_f32.shape[-1])


packed_tail.launches = 0
