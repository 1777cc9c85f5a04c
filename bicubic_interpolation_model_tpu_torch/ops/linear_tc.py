"""Dense linears ``y = x W + b`` with their epilogue, as one CUDA kernel
(``csrc/linear_tc.cu``).

The kernel replaces no TPU kernel: the JAX package left its matrix
products to XLA. It is the port's own, for SwinIR's Swin blocks
(``models/swinir.py``), whose linears cuBLAS's f32 route runs on the CUDA
cores: a GEMM of ``x [M, K]`` (row-major) by a Dense kernel ``W [K, N]``
whose products are 3xTF32 on the tensor cores, f32 accurate, with the bias
and one of these epilogues applied as it stores:

- ``"none"``: ``x W + b`` (a block's qkv);
- ``"gelu"``: the exact (erf) GELU of it, as ``F.gelu`` computes by
  default (fc1);
- ``"residual"``: ``residual + (x W + b)`` (proj and fc2); the output may
  be the residual tensor itself.

:func:`linear_tc` takes float32 tensors on the card with grad off, ``K`` a
multiple of 4 and ``N`` even, and launches the kernel or raises;
:func:`linear_reference`, the plain version (``torch.addmm`` with f32
products in full, then the epilogue in PyTorch), serves every other case
and is what the CPU tests run. The kernel's B operand is
:func:`packed_weights`, kept on the kernel tensor once built and rebuilt
when the tensor is changed in place.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..runtime import build
from ..runtime.device import full_f32_matmul
from .conv3x3 import tf32_rn

#: the epilogues, by the kernel's mode number
EPILOGUES = ("none", "gelu", "residual")
#: k a stage of the kernel, and its k8 steps
KC, STEPS = 32, 4
#: the columns of the kernel's tile (of 128 rows): N = 540, 360 and 180
#: take 3, 2 and 1 tiles
TILE_COLUMNS = 184
_PACKED = "_linear_tc_packed"


def serves(x: torch.Tensor) -> bool:
    """Whether :func:`linear_tc` takes ``x``'s device and dtype: float32
    on the card."""
    return x.device.type == "cuda" and x.dtype == torch.float32


def k_order() -> torch.Tensor:
    """The column of a 32-k stage that k8 step ``s``, fragment column
    ``kk`` reads, at ``[8 s + kk]``: ``16 (s // 2) + 4 (kk % 4) + 2 (s %
    2) + kk // 4`` (a thread's fragments of the four steps are two 16-byte
    loads a row)."""
    s = torch.arange(STEPS).repeat_interleave(8)
    kk = torch.arange(8).repeat(STEPS)
    return 16 * (s // 2) + 4 * (kk % 4) + 2 * (s % 2) + kk // 4


def pack(kernel: torch.Tensor) -> torch.Tensor:
    """The kernel's B operand from a ``[K, N]`` Dense kernel: each weight
    split into ``hi = tf32_rn(w)`` and ``lo = tf32_rn(w - hi)``, K
    zero-padded to a multiple of 32 and N to one of :data:`TILE_COLUMNS`,
    in the order ``[K / 32][step][hi, lo][N / 8][2][8][4]``: per stage, k8
    step (its columns in :func:`k_order`) and part, wgmma's K-major core
    matrices without swizzle, each 8 columns ``8 q ..`` x 4 k (128 bytes),
    the two halves of the step side by side."""
    k, n = kernel.shape
    kp, np_ = -(-k // KC) * KC, -(-n // TILE_COLUMNS) * TILE_COLUMNS
    w = kernel.new_zeros((kp, np_), dtype=torch.float32)
    w[:k, :n] = kernel
    hi = tf32_rn(w)
    w = torch.stack([hi, tf32_rn(w - hi)])            # [hl, kp, np]
    w = w.reshape(2, kp // KC, KC, np_)[:, :, k_order().to(w.device)]
    # [hl, stage, (s, h, k4), (q, r)]  ->  [stage, s, hl, q, h, r, k4]
    w = w.reshape(2, kp // KC, STEPS, 2, 4, np_ // 8, 8)
    return w.permute(1, 2, 0, 5, 3, 6, 4).contiguous().reshape(-1)


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


def linear_reference(x, kernel, bias, epilogue="none", *, residual=None,
                     out=None):
    """The plain PyTorch version, in ``x``'s dtype: ``torch.addmm`` with
    f32 products in full (``full_f32_matmul``), then the epilogue. ``out``
    (the residual epilogue only) receives the sum; without it the result
    differentiates."""
    with full_f32_matmul():
        y = torch.addmm(bias, x, kernel)
    if epilogue == "gelu":
        return F.gelu(y)
    if epilogue == "residual":
        return residual + y if out is None else torch.add(residual, y,
                                                          out=out)
    return y


def _check(name, t, shape, like):
    if t.shape != shape or not t.is_contiguous():
        raise ValueError(f"linear_tc: {name} must be a contiguous "
                         f"{tuple(shape)}, got {tuple(t.shape)} strides "
                         f"{t.stride()}")
    if t.dtype != like.dtype or t.device != like.device:
        raise ValueError(f"linear_tc: {name} is {t.dtype} on {t.device}, "
                         f"x {like.dtype} on {like.device}")


def linear_tc(x, kernel, bias, epilogue="none", *, residual=None, out=None):
    """``epilogue(x @ kernel + bias)`` of ``x [M, K]`` and a Dense kernel
    ``[K, N]``: ``[M, N]``, into ``out`` when given (the residual epilogue
    only; ``out`` may be ``residual``). Launches the kernel (float32 on the
    card, grad off, K a multiple of 4, N even, every tensor contiguous) or
    raises."""
    if epilogue not in EPILOGUES:
        raise ValueError(f"linear_tc: epilogue {epilogue!r} not in "
                         f"{EPILOGUES}")
    if x.dim() != 2 or kernel.dim() != 2 or x.shape[1] != kernel.shape[0]:
        raise ValueError(f"linear_tc takes x [M, K] and a kernel [K, N], "
                         f"got {tuple(x.shape)} and {tuple(kernel.shape)}")
    (m, k), n = x.shape, kernel.shape[1]
    if k % 4 or n % 2:
        raise ValueError(f"linear_tc: K a multiple of 4 and N even, got K "
                         f"{k}, N {n}")
    _check("x", x, x.shape, x)
    _check("kernel", kernel, kernel.shape, x)
    _check("bias", bias, torch.Size((n,)), x)
    if (residual is None) != (epilogue != "residual"):
        raise ValueError("linear_tc: a residual with the residual epilogue "
                         "and with no other")
    if out is not None and residual is None:
        raise ValueError("linear_tc: out with the residual epilogue only")
    for name, t in (("residual", residual), ("out", out)):
        if t is not None:
            _check(name, t, torch.Size((m, n)), x)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, kernel, bias, residual)):
        raise ValueError("linear_tc has no backward: call it with grad off")
    if not serves(x):
        raise ValueError(f"linear_tc: {x.dtype} on {x.device} (float32 on "
                         "the card)")
    if out is None:
        out = torch.empty((m, n), device=x.device)
    wpk = packed_weights(kernel)
    lib = build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.bim_linear_tc(
            x.data_ptr(), k, wpk.data_ptr(), bias.data_ptr(), m, k, n,
            TILE_COLUMNS, out.data_ptr(), n,
            None if residual is None else residual.data_ptr(), n,
            EPILOGUES.index(epilogue), stream)
    build.check(rc, "linear_tc")
    linear_tc.launches += 1
    return out


linear_tc.launches = 0
