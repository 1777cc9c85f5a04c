"""A named grid of devices (counterpart of
``bicubic_interpolation_model_tpu/parallel/mesh.py``).

JAX's ``shard_map`` runs one program over a mesh from one controller; the
port keeps that shape. A :class:`Mesh` is a numpy object array of
``torch.device`` s with axis names, and the sharded functions loop over the
devices of one axis in one process, each band or shard on its own device.
A device may repeat: ``Mesh([torch.device("cuda", 0)] * 4, ("spatial",))``
runs four bands on one card, and the same code spreads them over four cards
(copies between bands go peer to peer). ``torch.distributed`` serves only
the multi-host part (:mod:`.distributed`).

The JAX module's ``replicated`` / ``batch_sharding`` name shardings of
``jax.sharding``; PyTorch has no such system, so they have no counterpart.
"""

from __future__ import annotations

import numpy as np
import torch


class Mesh:
    """``devices`` (nested lists or an array of devices or names, one
    array dimension per axis) with ``axis_names``; ``shape`` is
    ``{name: size}`` as JAX's is."""

    def __init__(self, devices, axis_names):
        names = tuple(axis_names)
        arr = np.asarray(devices, dtype=object)
        if arr.ndim != len(names) or len(set(names)) != len(names):
            raise ValueError(f"{arr.ndim}-D devices for axis names {names}")
        self.devices = np.empty(arr.shape, dtype=object)
        for ix in np.ndindex(arr.shape):
            self.devices[ix] = torch.device(arr[ix])
        self.axis_names = names

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    def axis_devices(self, axis: str) -> list[torch.device]:
        """The devices along ``axis`` at index 0 of every other axis: where
        a sharded function places its bands or shards (the other axes
        would only replicate the work)."""
        if axis not in self.axis_names:
            raise ValueError(f"no axis {axis!r} in mesh axes "
                             f"{self.axis_names}")
        k = self.axis_names.index(axis)
        line = np.moveaxis(self.devices, k, 0).reshape(
            self.devices.shape[k], -1)[:, 0]
        return list(line)


def _grid(devs, axis_names, spatial) -> Mesh:
    n = len(devs)
    if spatial is None:
        spatial = 1
        while (spatial * 2) ** 2 <= n and n % (spatial * 2) == 0:
            spatial *= 2
    if n % spatial:
        raise ValueError(f"{n} devices not divisible by spatial={spatial}")
    arr = np.empty(n, dtype=object)
    arr[:] = list(devs)
    return Mesh(arr.reshape(n // spatial, spatial), axis_names)


def make_mesh(n_devices: int | None = None,
              axis_names: tuple[str, str] = ("data", "spatial"),
              spatial: int | None = None,
              device_type: str = "cuda") -> Mesh:
    """A (data x spatial) mesh over the first ``n_devices`` visible devices
    of ``device_type`` (all of them by default).

    ``spatial`` defaults to the largest power of two ≤ sqrt(n) that divides
    n: 8 devices → 4x2, 4 → 2x2, 2 → 2x1, 1 → 1x1. Raises when fewer than
    ``n_devices`` devices of that type are visible (the CPU counts as one);
    it never repeats a device to fill a mesh: build a mesh of n bands on one
    card explicitly with :class:`Mesh`."""
    if device_type == "cuda":
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        visible = [torch.device("cuda", i) for i in range(count)]
    elif device_type == "cpu":
        visible = [torch.device("cpu")]
    else:
        raise ValueError(f"unknown device type {device_type!r}")
    if not visible or (n_devices is not None and len(visible) < n_devices):
        raise ValueError(
            f"requested a {n_devices or 'full'}-device mesh but "
            f"{len(visible)} {device_type} device(s) are visible")
    return _grid(visible[:n_devices] if n_devices else visible, axis_names,
                 spatial)
