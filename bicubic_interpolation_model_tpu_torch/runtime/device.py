"""Where entry points run: the card unless the caller asks for the CPU."""

from __future__ import annotations

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
