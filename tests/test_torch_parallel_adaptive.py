"""The port's band-sharded adaptive bicubic (bicubic_interpolation_model_tpu_
torch/parallel/spatial.adaptive_resize_spatial_sharded) against the port's
single-frame kernel E (its plain version on the CPU) and against the JAX
package's sharded function on its 8-device CPU mesh, frames made by numpy
from a seed.

Tolerances: byte-equal to the single-frame kernel E on uniform noise and on
frames that reach all three region classes (each band runs kernel E on its
rows plus the real rows adaptive bicubic reads around them, so every kept
row sees what the single frame sees); ≤1 u8 LSB from the JAX sharded
function on noise only, the frames its Pallas kernel agrees with the
oracle on (ROADMAP queue C: it deviates at the last LR row on frames that
leave the edge class)."""

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
from chip_smoke import all_class_frames


def _noise(seed, h, w, c):
    return np.random.default_rng(seed).integers(0, 256, (h, w, c),
                                                dtype=np.uint8)


def _mesh(n):
    return Mesh(["cpu"] * n, ("spatial",))


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("c", [4, 3])
@pytest.mark.parametrize("frame", ["noise", "all_classes"])
def test_equals_the_single_frame_kernel(n, c, frame):
    h, w = 12 * n, 22
    img = (_noise(n + c, h, w, c) if frame == "noise" else all_class_frames(
        np.random.default_rng(n + c), 1, h, w, c)[0])
    for s in (2, 4):
        got = adaptive_resize_spatial_sharded(img, s, mesh=_mesh(n))
        assert got.shape == (h * s, w * s, c) and got.dtype == torch.uint8
        assert torch.equal(got, adaptive_resize_fused(img, s, device="cpu"))
    planar = adaptive_resize_spatial_sharded(img, 4, mesh=_mesh(n),
                                             layout="planar")
    assert planar.shape == (4, h * 4, w) and planar.dtype == torch.uint32
    assert torch.equal(planar, adaptive_resize_fused(img, 4, device="cpu",
                                                     layout="planar"))


def test_bands_of_three_rows_equal_the_single_frame_kernel():
    """The shortest bands the JAX function takes: a band's window then
    reaches into the bands beyond its neighbours."""
    img = all_class_frames(np.random.default_rng(9), 1, 24, 17, 4)[0]
    got = adaptive_resize_spatial_sharded(img, 3, mesh=_mesh(8))
    assert torch.equal(got, adaptive_resize_fused(img, 3, device="cpu"))


@pytest.mark.parametrize("n", [2, 4])
def test_matches_jax_on_noise(n):
    img = _noise(30 + n, 16, 20, 4)
    jmesh = jax_make_mesh(n, spatial=n)
    ref = np.asarray(jax_adaptive_sharded(img, 4, mesh=jmesh))
    got = adaptive_resize_spatial_sharded(img, 4, mesh=_mesh(n)).numpy()
    assert got.shape == ref.shape
    assert np.abs(got.astype(np.int64) - ref.astype(np.int64)).max() <= 1
    ref_p = np.asarray(jax_adaptive_sharded(img, 4, mesh=jmesh,
                                            layout="planar"))
    got_p = adaptive_resize_spatial_sharded(img, 4, mesh=_mesh(n),
                                            layout="planar").numpy()
    assert ref_p.shape[1] == got_p.shape[1] and ref_p.shape[2] >= 20
    d = np.abs(got_p.view(np.uint8).astype(np.int64)
               - ref_p[..., :20].copy().view(np.uint8).astype(np.int64))
    assert d.max() <= 1


def test_checks():
    mesh = _mesh(4)
    with pytest.raises(ValueError, match="not divisible"):
        adaptive_resize_spatial_sharded(np.zeros((18, 16, 4), np.uint8), 4,
                                        mesh=mesh)
    with pytest.raises(ValueError, match="integer"):
        adaptive_resize_spatial_sharded(np.zeros((16, 16, 4), np.uint8), 1.5,
                                        mesh=mesh)
    with pytest.raises(ValueError, match="at least 3 rows"):
        adaptive_resize_spatial_sharded(np.zeros((8, 16, 4), np.uint8), 2,
                                        mesh=mesh)
    with pytest.raises(ValueError, match="uint8"):
        adaptive_resize_spatial_sharded(np.zeros((16, 16, 4), np.float32), 2,
                                        mesh=mesh)
    with pytest.raises(ValueError, match="layout"):
        adaptive_resize_spatial_sharded(np.zeros((16, 16, 4), np.uint8), 2,
                                        mesh=mesh, layout="hwc32")
