"""3x3 stride-1 SAME convs on channel-major float32 frames, with their
epilogue, as one CUDA kernel (``csrc/conv3x3_tc.cu``).

The kernel replaces no TPU kernel: the JAX package left its convs to XLA.
It is the port's own, for the published ESRGAN generator's trunk and HR
stage (``models/esrgan.py``), whose convs cuDNN's f32 route runs on the
CUDA cores: an implicit GEMM (M = output pixels, N = output channels, K =
9 input channels) whose products are 3xTF32 on the tensor cores, f32
accurate, with the bias and one of these epilogues applied as it stores:

- ``leaky``: leaky ReLU 0.2;
- ``residual``: ``residual + alpha * y``, then optionally ``outer +
  OUTER_SCALE * (...)`` (a dense block's scaled residual and the RRDB's
  outer one);
- neither: the conv and its bias.

Frames are ``[1, C, H, W]`` tensors whose last dimension is contiguous;
the other strides are free, so the output, the residual and the outer term
may be slices of a larger buffer (a dense block's buffer's interior). With
``padding=0`` the input carries its own zero border (``[1, C, H + 2, W +
2]`` for an ``[H, W]`` output), with ``padding=1`` the kernel reads zeros
outside the frame.

The kernel takes input channels in multiples of 8 and 1 to 64 output
channels (instances of 32 and 64: fewer are zero columns of the packed
weights). Its B operand is :func:`packed_weights`, kept on the kernel
tensor once built and rebuilt when the tensor is changed in place.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..runtime import build

#: output channels of the kernel's two instances
WIDTHS = (32, 64)
#: the scale of the ``outer`` term's residual: the RRDB's 0.2
OUTER_SCALE = 0.2
_PACKED = "_conv3x3_tc_packed"


def serves(x: torch.Tensor) -> bool:
    """Whether :func:`conv3x3_tc` takes frames of ``x``'s device and dtype:
    any float on the CPU (the plain version), float32 on the card."""
    if x.device.type == "cpu":
        return x.dtype.is_floating_point
    return x.device.type == "cuda" and x.dtype == torch.float32


def _width(c_out: int) -> int:
    return next(n for n in WIDTHS if c_out <= n)


def tf32_rn(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to the nearest TF32 value (10 mantissa bits;
    ties away from zero), as the kernel rounds: half a TF32 ulp added to
    the bits, the low 13 bits cleared."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def pack(kernel: torch.Tensor) -> torch.Tensor:
    """The kernel's B operand from an HWIO ``[3, 3, C_in, C_out]`` kernel:
    each weight split into ``hi = tf32_rn(w)`` and ``lo = tf32_rn(w -
    hi)``, output channels zero-padded to the instance's width N, in the
    order ``[C_in / 8][tap][hi, lo][N / 8][2][8][4]``: per k8 step (8
    input channels ``8 c8 ..``, one tap) and part, wgmma's K-major core
    matrices without swizzle, each 8 output channels ``8 q ..`` x 4 input
    channels ``8 c8 + 4 h ..`` (128 bytes), the two halves of K side by
    side."""
    kh, kw, c_in, c_out = kernel.shape
    n = _width(c_out)
    w = kernel.new_zeros((kh, kw, c_in, n), dtype=torch.float32)
    w[..., :c_out] = kernel
    hi = tf32_rn(w)
    w = torch.stack([hi, tf32_rn(w - hi)], dim=2)    # [ky, kx, hl, ci, n]
    # ci = 8 c8 + 4 h + k, n = 8 q + r  ->  [c8, ky, kx, hl, q, h, r, k]
    w = w.reshape(kh, kw, 2, c_in // 8, 2, 4, n // 8, 8)
    return w.permute(3, 0, 1, 2, 6, 4, 7, 5).contiguous().reshape(-1)


@torch.no_grad()
def packed_weights(kernel: torch.Tensor) -> torch.Tensor:
    """:func:`pack` of ``kernel``, kept on the tensor and built again when
    the tensor has been changed in place since (its version counter)."""
    cached = getattr(kernel, _PACKED, None)
    if cached is not None and cached[0] == kernel._version:
        return cached[1]
    packed = pack(kernel.detach())
    setattr(kernel, _PACKED, (kernel._version, packed))
    return packed


def conv3x3_tc_reference(x, kernel, bias, *, padding=1, out=None,
                         leaky=False, residual=None, alpha=1.0, outer=None):
    """The plain PyTorch version: ``F.conv2d`` (the HWIO kernel as OIHW)
    with its bias, then the epilogue, in ``x``'s dtype; its last pass
    writes ``out``."""
    y = F.conv2d(x, kernel.permute(3, 2, 0, 1), bias, padding=padding)
    dst = y if out is None else out
    if residual is None:
        if leaky:
            return torch.ops.aten.leaky_relu.out(y, 0.2, out=dst)
        return y if out is None else out.copy_(y)
    if leaky:
        F.leaky_relu(y, 0.2, inplace=True)
    if outer is None:
        return torch.add(residual, y, alpha=alpha, out=dst)
    torch.add(residual, y, alpha=alpha, out=y)
    return torch.add(outer, y, alpha=OUTER_SCALE, out=dst)


def _check_frame(name, t, shape, x):
    if t.shape != shape or t.stride(-1) != 1:
        raise ValueError(f"conv3x3_tc: {name} must be {tuple(shape)} with "
                         f"a contiguous last dimension, got "
                         f"{tuple(t.shape)} strides {t.stride()}")
    if t.dtype != x.dtype or t.device != x.device:
        raise ValueError(f"conv3x3_tc: {name} is {t.dtype} on {t.device}, "
                         f"the input {x.dtype} on {x.device}")


def _planes(t):
    return (t.data_ptr(), t.stride(1), t.stride(2)) if t is not None \
        else (None, 0, 0)


def conv3x3_tc(x, kernel, bias, *, padding=1, out=None, leaky=False,
               residual=None, alpha=1.0, outer=None):
    """``out = epilogue(conv3x3(x) + bias)`` on a ``[1, C_in, Hs, Ws]``
    frame with an HWIO ``[3, 3, C_in, C_out]`` kernel: ``[1, C_out, H,
    W]`` with ``H = Hs - 2 + 2 padding`` (the same for W), into ``out``
    when given. A CUDA tensor launches the kernel (float32 only) or
    raises; a CPU tensor runs :func:`conv3x3_tc_reference`. Raises on
    shapes, dtypes and strides the kernel does not take."""
    if x.dim() != 4 or x.shape[0] != 1 or x.stride(-1) != 1:
        raise ValueError(f"conv3x3_tc takes one [1, C, H, W] frame with a "
                         f"contiguous last dimension, got {tuple(x.shape)} "
                         f"strides {x.stride()}")
    if not serves(x):
        raise ValueError(f"conv3x3_tc: {x.dtype} on {x.device} (float32 on "
                         "the card, a float on the CPU)")
    _, c_in, hs, ws = x.shape
    if (kernel.shape[:3] != (3, 3, c_in) or c_in % 8
            or not 1 <= kernel.shape[3] <= WIDTHS[-1]):
        raise ValueError(f"conv3x3_tc takes a [3, 3, C_in, C_out] kernel "
                         f"with C_in a multiple of 8 and C_out <= "
                         f"{WIDTHS[-1]}, on a frame of {c_in} channels: got "
                         f"{tuple(kernel.shape)}")
    if padding not in (0, 1):
        raise ValueError(f"conv3x3_tc: padding 0 or 1, got {padding}")
    c_out = kernel.shape[3]
    h, w = hs - 2 + 2 * padding, ws - 2 + 2 * padding
    if h < 1 or w < 1:
        raise ValueError(f"conv3x3_tc: no output from a {hs}x{ws} frame "
                         f"with padding {padding}")
    shape = torch.Size((1, c_out, h, w))
    for name, t in (("kernel", kernel), ("bias", bias)):
        if t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f"conv3x3_tc: {name} is {t.dtype} on "
                             f"{t.device}, the input {x.dtype} on {x.device}")
    if bias.shape != (c_out,) or bias.stride(0) != 1:
        raise ValueError(f"conv3x3_tc: bias {tuple(bias.shape)} strides "
                         f"{bias.stride()} for {c_out} output channels")
    for name, t in (("out", out), ("residual", residual), ("outer", outer)):
        if t is not None:
            _check_frame(name, t, shape, x)
    if outer is not None and residual is None:
        raise ValueError("conv3x3_tc: outer needs a residual")
    if x.device.type == "cpu":
        return conv3x3_tc_reference(
            x, kernel, bias, padding=padding, out=out, leaky=leaky,
            residual=residual, alpha=alpha, outer=outer)
    if out is None:
        out = torch.empty(shape, device=x.device)
    wpk = packed_weights(kernel)
    lib = build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.bim_conv3x3_tc(
            x.data_ptr(), x.stride(1), x.stride(2), hs, ws, padding,
            wpk.data_ptr(), bias.data_ptr(), c_in, c_out, _width(c_out),
            out.data_ptr(), out.stride(1), out.stride(2), h, w, int(leaky),
            *_planes(residual), float(alpha), *_planes(outer), OUTER_SCALE,
            stream)
    build.check(rc, "conv3x3_tc")
    conv3x3_tc.launches += 1
    return out


conv3x3_tc.launches = 0
