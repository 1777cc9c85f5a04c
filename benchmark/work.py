"""Work counted from shapes, and the card's published peaks.

Frozen copies of the bound arithmetic that ``chip_smoke.py`` applies to
kernels A and C (``ops_bound``, ``tail_bound``, ``resize_bound``), plus
the learned model step's FLOPs from its layer shapes. A count is what the
inputs need, each input byte read once and each output byte written once,
whatever a kernel reads again.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, at the full 700 W
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12
BF16_FLOP_PER_S = 989e12
#: f32-accurate products on the tensor cores: 3xTF32, three TF32 passes
F32_MMA_FLOP_PER_S = TF32_FLOP_PER_S / 3


def ops_bound(nbytes, products, other, bf16=False):
    """Least ms of a kernel that moves ``nbytes``, runs ``products`` FLOPs
    of matrix products on the tensor cores (3xTF32 on the f32 route, one
    bf16 pass on the bf16 route) and ``other`` FLOPs on the f32 CUDA
    cores: the largest of the three times. Returns (ms, "bytes" or
    "operations")."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_mma = (products / BF16_FLOP_PER_S if bf16
             else 3 * products / TF32_FLOP_PER_S) * 1e3
    t_ops = max(t_mma, other / F32_FLOP_PER_S * 1e3)
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def tail_bound(h, w, c, y_bytes=4):
    """Least ms of the learned model's fused tail on one [h, w, c] LR
    frame at 4x with 32 features and 16 weights: features, pixels and
    output words read or written once; the upsample (256 up-lanes) and
    conv_out over the 16 gated up-lanes of 9 taps x 16 phases on the tensor
    cores; the attention dot, tanh and the 16-tap apply on the CUDA cores.
    Returns (ms, bound by, bytes, FLOPs)."""
    m = h * w
    nbytes = m * 32 * y_bytes + m * c * 4 + m * 16 * 4
    products = 2 * m * (32 * 256 + 16 * 9 * 16 * 16)
    other = m * (2 * 256 + 256 + 2 * 16 * 16 * c)
    return (*ops_bound(nbytes, products, other, y_bytes == 2), nbytes,
            products + other)


def resize_bound(b, h, w, c, ho, wo, taps, in_bytes=1):
    """Least ms of a separable resize [b, h, w, c] -> [b, ho, wo, c]:
    input read once and output written once over the HBM rate, or a
    multiply-add per tap (row pass over ho x w, column pass over ho x wo)
    over the f32 peak. Returns (ms, bound by, bytes, FLOPs)."""
    nbytes = b * c * in_bytes * (h * w + ho * wo)
    flops = 2 * taps * b * c * (ho * w + ho * wo)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), nbytes, flops


def conv_flops(h, w, k, n_in, n_out):
    """FLOPs (2 per multiply-add) of a k x k conv over an h x w map."""
    return 2 * h * w * k * k * n_in * n_out


def weight_predictor_flops(h, w, c=4, features=32, scale=4):
    """FLOPs of the learned model step on one [h, w, c] LR frame, from the
    checkpoint's layer shapes: conv_in and conv_res at LR resolution, then
    the tail as :func:`tail_bound` counts it (conv_off is a per-phase
    constant, conv_out runs over the gated up-lanes only). About 113.7
    kFLOP per LR pixel at the published widths."""
    if scale != 4:
        raise ValueError(f"the tail's count is written for 4x, not {scale}")
    convs = conv_flops(h, w, 3, c, features) + conv_flops(
        h, w, 3, features, features)
    return convs + tail_bound(h, w, c)[3]
