"""The channel-packed planar u32 layout shared by the fused tail's output
and its deliveries.

Word ``(px, r, X)`` of a ``[S, R, X]`` uint32 array holds the c channel
bytes of output pixel ``(r, X*S + px)``, little-endian (bytes >= c zero).
Counterparts of ``ops/pallas_resize._round_up`` and
``ops/pallas_adaptive.unpack_planar`` in the JAX package.
"""

from __future__ import annotations

import torch


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pack_rgba32(u8_hwc: torch.Tensor) -> torch.Tensor:
    """[..., W, c<=4] uint8 → [..., W] uint32 with the channel bytes
    little-endian (bytes >= c zero). A byte view, no shifts: torch has no
    uint32 ``<<`` on the CPU."""
    c = u8_hwc.shape[-1]
    if c < 4:
        u8_hwc = torch.nn.functional.pad(u8_hwc, (0, 4 - c))
    return u8_hwc.contiguous().view(torch.uint32)[..., 0]


def unpack_planar(packed_u32: torch.Tensor, h: int, w: int, scale: int,
                  c: int) -> torch.Tensor:
    """[..., S, R, X] channel-packed u32 planar → [..., h*S, w*S, c] uint8
    (byte view, then the [S,R,X,4] → [R,X,S,4] permute)."""
    s = int(scale)
    lead = packed_u32.shape[:-3]
    b = packed_u32.contiguous().view(torch.uint8).reshape(
        packed_u32.shape + (4,))[..., :h * s, :w, :c]    # [.., S, hS, w, c]
    nd = b.dim()
    o = b.permute(*range(nd - 4), nd - 3, nd - 2, nd - 4, nd - 1)
    return o.reshape(lead + (h * s, w * s, c))
