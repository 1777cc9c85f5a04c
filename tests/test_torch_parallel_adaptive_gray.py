"""The port's band-sharded adaptive bicubic (bicubic_interpolation_model_tpu_
torch/parallel/spatial.adaptive_resize_spatial_sharded) on 1- and 2-channel
uint8 frames, against the port's single-frame kernel E (its plain version on
the CPU) and against the JAX package's sharded function on its CPU mesh, on
the all-class frames of tests/test_torch_adaptive.py.

Tolerances: byte-equal to the single-frame kernel E, hwc and planar (each
band runs kernel E on its rows plus the real rows adaptive bicubic reads
around them); ≤1 u8 LSB from the JAX sharded function on the whole frame
(f32 sums in another order; its per-band Pallas kernels deviate from the
oracle at the last LR row, by at most 1 on these frames)."""

import numpy as np
import pytest
import torch

from bicubic_interpolation_model_tpu.parallel.mesh import (
    make_mesh as jax_make_mesh)
from bicubic_interpolation_model_tpu.parallel.spatial import (
    adaptive_resize_spatial_sharded as jax_adaptive_sharded)
from bicubic_interpolation_model_tpu_torch.ops.adaptive_fused import (
    adaptive_resize_fused)
from bicubic_interpolation_model_tpu_torch.parallel.mesh import Mesh
from bicubic_interpolation_model_tpu_torch.parallel.spatial import (
    adaptive_resize_spatial_sharded)

from test_torch_adaptive import FRAMES, _max_diff, all_class_frame


def _mesh(n):
    return Mesh(["cpu"] * n, ("spatial",))


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("c", [1, 2])
def test_equals_the_single_frame_kernel(n, c):
    for name in FRAMES:
        img = all_class_frame(name, 24, 70, c, seed=n + c)
        for s in (1, 2, 3, 4):
            got = adaptive_resize_spatial_sharded(img, s, mesh=_mesh(n))
            assert got.shape == (24 * s, 70 * s, c)
            assert torch.equal(got, adaptive_resize_fused(img, s,
                                                          device="cpu"))
        planar = adaptive_resize_spatial_sharded(img, 3, mesh=_mesh(n),
                                                 layout="planar")
        assert planar.shape == (3, 72, 70) and planar.dtype == torch.uint32
        assert torch.equal(planar, adaptive_resize_fused(
            img, 3, device="cpu", layout="planar"))


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("c", [1, 2])
def test_matches_the_jax_sharded_function(n, c):
    jmesh = jax_make_mesh(n, spatial=n)
    for name in FRAMES:
        img = all_class_frame(name, 24, 70, c, seed=n + c)
        ref = np.asarray(jax_adaptive_sharded(img, 2, mesh=jmesh))
        got = adaptive_resize_spatial_sharded(img, 2, mesh=_mesh(n)).numpy()
        assert got.shape == ref.shape == (48, 140, c)
        assert _max_diff(got, ref) <= 1, name
