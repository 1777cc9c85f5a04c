"""Work of the published ESRGAN generator (RRDBNet at 4x), counted from its
layer shapes.

Every conv is 3x3 with a bias. At LR resolution: conv_first, the 23 RRDBs'
69 dense blocks of 5 convs (inputs of 64, 96, 128, 160 and 192 channels at
the published widths) and conv_body; conv_up1 on the 2x grid; conv_up2,
conv_hr and conv_last on the 4x grid. 35,853,696 FLOP a LR pixel.

A conv's bytes are its input read once, its output written once and its
weights read once, in float32. A dense block's concatenations copy the
channels that its convs 2 to 5 take (96 + 128 + 160 + 192 at the published
widths), each read once and written once: 4,608 B a LR pixel a block. The
convs' least time is :func:`benchmark.work.ops_bound` of their bytes and
FLOPs, products at the rate of f32-accurate tensor-core products (3xTF32,
165 TFLOP/s), the yardstick of ``model_mfu.*``.
"""

from __future__ import annotations

from benchmark import work

F32 = 4


def convs(h, w, features=64, growth=32, n_blocks=23, channels=3):
    """``[(pixels, in, out)]`` of every conv of one [h, w] LR frame."""
    lr, f = h * w, features
    out = [(lr, channels, f)]
    for _ in range(3 * n_blocks):
        out += [(lr, f + i * growth, growth) for i in range(4)]
        out.append((lr, f + 4 * growth, f))
    out.append((lr, f, f))
    out += [(4 * lr, f, f), (16 * lr, f, f), (16 * lr, f, f),
            (16 * lr, f, channels)]
    return out


def flops(h, w, **dims):
    """FLOPs (2 per multiply-add) of the model on one [h, w] LR frame."""
    return sum(work.conv_flops(1, px, 3, n_in, n_out)
               for px, n_in, n_out in convs(h, w, **dims))


def conv_bytes(h, w, **dims):
    """Bytes the convs move: each input read once, each output written
    once, each weight and bias read once (float32)."""
    return sum(F32 * (px * (n_in + n_out) + 9 * n_in * n_out + n_out)
               for px, n_in, n_out in convs(h, w, **dims))


def concat_bytes(h, w, features=64, growth=32, n_blocks=23, **_):
    """Bytes the dense blocks' concatenations move (read and written once):
    the inputs of convs 2 to 5 of each of the 3 * ``n_blocks`` blocks."""
    per_block = sum(features + i * growth for i in range(1, 5))
    return 2 * F32 * h * w * per_block * 3 * n_blocks


def conv_bound(h, w, **dims):
    """(least ms of the convs on one frame, "bytes" or "operations")."""
    return work.ops_bound(conv_bytes(h, w, **dims), flops(h, w, **dims), 0)
