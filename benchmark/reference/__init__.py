"""Plain references that decide ``correct``.

Written from the published descriptions in plain PyTorch, on whatever
device their inputs lie on. Nothing here imports the program under test
(``bicubic_interpolation_model_tpu_torch``), the JAX package or JAX, and
nothing here takes what the program made: a reference reads the raw
checkpoint file itself and works every derived table out again.

Each reference runs in a ``precision``: ``"float64"`` is the oracle;
``"tf32"`` is the control, the same arithmetic in float32 with the
operands of every product (conv and matmul) rounded to TF32 as a tensor
core with TF32 on rounds them, the step below the float32 with TF32 off
that the configurations state.
"""

from __future__ import annotations

import torch

PRECISIONS = ("float64", "tf32")


def dtype_of(precision: str) -> torch.dtype:
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got "
                         f"{precision!r}")
    return torch.float64 if precision == "float64" else torch.float32


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32 (10 explicit mantissa bits), to the
    nearest, ties to even, as the tensor cores take their operands."""
    if x.dtype != torch.float32:
        raise TypeError(f"tf32_round takes float32, got {x.dtype}")
    bits = x.contiguous().view(torch.int32)
    keep = (bits >> 13) & 1
    rounded = (bits + 0x0FFF + keep) & ~0x1FFF
    return rounded.view(torch.float32)


def operand(x: torch.Tensor, precision: str) -> torch.Tensor:
    """A product's operand as ``precision`` hands it to the multiplier."""
    return tf32_round(x) if precision == "tf32" else x
