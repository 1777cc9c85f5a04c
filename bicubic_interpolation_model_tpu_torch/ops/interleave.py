"""Column-phase interleave of packed-u32 planar frames (CUDA kernel B).

``[S, R, X]`` uint32 planes → ``[R, X*S]`` "RGBA32 HWC" words, word
``(r, X*S + px) = planar[px, r, X]``: the little-endian bytes of the result
ARE the HWC uint8 image. Counterpart of
``bicubic_interpolation_model_tpu/ops/pallas_interleave.py``; the kernel is
``csrc/interleave.cu``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..runtime import build


def interleave_planar_u32_reference(planar_u32: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of the kernel."""
    s, r, x = planar_u32.shape
    return planar_u32.permute(1, 2, 0).reshape(r, x * s)


def interleave_planar_u32(planar_u32: torch.Tensor) -> torch.Tensor:
    """[S, R, X] uint32 → [R, X*S] uint32. On a CUDA tensor this launches
    the kernel (or raises); on a CPU tensor it runs the plain version."""
    if planar_u32.dtype != torch.uint32 or planar_u32.dim() != 3:
        raise ValueError("interleave_planar_u32 expects a [S, R, X] uint32 "
                         f"tensor, got {planar_u32.dtype} "
                         f"{tuple(planar_u32.shape)}")
    s, r, x = planar_u32.shape
    if not 1 <= s <= 16:
        raise ValueError(f"interleave_planar_u32 takes 1 <= S <= 16, got {s}")
    if planar_u32.device.type == "cpu":
        return interleave_planar_u32_reference(planar_u32)
    if planar_u32.device.type != "cuda":
        raise ValueError(f"unsupported device {planar_u32.device}")
    if not planar_u32.is_contiguous():
        raise ValueError("interleave_planar_u32 needs a contiguous tensor")
    out = torch.empty((r, x * s), dtype=torch.uint32,
                      device=planar_u32.device)
    if out.numel():
        lib = build.library()
        with torch.cuda.device(planar_u32.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc = lib.bim_interleave_planar_u32(
                planar_u32.data_ptr(), out.data_ptr(), s, r, x, stream)
        build.check(rc, "interleave_planar_u32")
        interleave_planar_u32.launches += 1
    return out


interleave_planar_u32.launches = 0


def rgba32_to_hwc_np(out_u32_np, h_out: int, w_out: int, c: int = 4):
    """Host-side free view of a fetched RGBA32 frame as HWC uint8."""
    a = np.ascontiguousarray(out_u32_np[:h_out, :w_out])
    return a.view(np.uint8).reshape(h_out, w_out, 4)[..., :c]
