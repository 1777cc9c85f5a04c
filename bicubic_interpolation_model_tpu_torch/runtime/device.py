"""Where entry points run (the card unless the caller asks for the CPU),
and at what float32 precision: TF32 off in cuDNN and cuBLAS."""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a :class:`torch.device`; raises when CUDA is asked for
    and no card is visible — never a quiet drop to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels on the CPU")
    return dev


def as_device_tensor(img, device=None) -> torch.Tensor:
    """``img`` as a tensor for a kernel's wrapper. A tensor stays where it
    lies unless ``device`` says otherwise; anything else (a numpy frame, a
    list) has no place of its own and goes to ``device``: the card by
    default, and without one it raises unless given ``device="cpu"``."""
    if isinstance(img, torch.Tensor) and device is None:
        return img
    return torch.as_tensor(img).to(
        resolve_device("cuda" if device is None else device))


def conv_precision(dtype):
    """Full-f32 cuDNN convs at float32 (cuDNN defaults to TF32) for this
    region only; the global flag is left alone."""
    if dtype == torch.float32:
        return torch.backends.cudnn.flags(enabled=True, allow_tf32=False)
    return contextlib.nullcontext()


@contextlib.contextmanager
def full_f32_matmul():
    """f32 products in full precision whatever the caller's TF32 flag (the
    JAX package asks for Precision.HIGHEST)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
