"""Data-parallel batch resize over the devices of a mesh axis (counterpart
of ``bicubic_interpolation_model_tpu/parallel/batch.py``).

Each device runs kernel D (:func:`..ops.phase.resize_phase`) on its shard
of the batch; frames are independent, so shards exchange nothing. Pair with
:mod:`.spatial` when a single frame is too large for one device instead.
"""

from __future__ import annotations

import torch

from ..ops.phase import resize_phase
from .mesh import Mesh


def resize_batch_sharded(imgs, scale, method: str = "bicubic", *,
                         mesh: Mesh, axis: str = "data", a: float = -0.5):
    """[B, H, W, C] batch (numpy or tensor) sharded over ``mesh[axis]``; B
    must divide evenly and the scale be an integer. Shard i goes to the
    axis's i-th device, where ``resize_phase`` launches kernel D (its plain
    version on a CPU device).

    Returns the upscaled batch as one tensor on the axis's first device
    (the JAX function returns an array that stays sharded)."""
    devs = mesh.axis_devices(axis)
    n = len(devs)
    x = torch.as_tensor(imgs)
    if x.dim() != 4:
        raise ValueError(f"expected [B, H, W, C], got {tuple(x.shape)}")
    if x.shape[0] % n:
        raise ValueError(f"batch {x.shape[0]} not divisible by {n} shards")
    if float(scale) != int(scale) or scale < 1:
        raise ValueError("sharded batch resize requires an integer upscale")
    per = x.shape[0] // n
    outs = [resize_phase(x[i * per:(i + 1) * per].to(dev, non_blocking=True),
                         int(scale), method, a=a)
            for i, dev in enumerate(devs)]
    return torch.cat([o.to(devs[0], non_blocking=True) for o in outs])
