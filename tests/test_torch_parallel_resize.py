"""The port's band-sharded classical resize (bicubic_interpolation_model_tpu_
torch/parallel/spatial.resize_spatial_sharded) against the JAX package's on
its 8-device CPU mesh and against the float64 ``core.oracle.resize_oracle``,
frames made by numpy from a seed.

The port's mesh repeats the CPU device n times. Tolerances: ≤1 u8 LSB from
the JAX function and from the oracle (f32 sums in another order);
``impl="mxu"`` byte-equal to the port's single-frame ``resize_mxu`` (its
plain version on the CPU: each band runs the same weights at the same
taps); the banded row matrices equal the JAX package's."""

import numpy as np
import pytest
import torch

from bicubic_interpolation_model_tpu.core.oracle import resize_oracle
from bicubic_interpolation_model_tpu.parallel import spatial as jax_spatial
from bicubic_interpolation_model_tpu.parallel.mesh import (
    make_mesh as jax_make_mesh)
from bicubic_interpolation_model_tpu.parallel.spatial import (
    resize_spatial_sharded as jax_resize_sharded)
from bicubic_interpolation_model_tpu_torch.core import plan as planlib
from bicubic_interpolation_model_tpu_torch.ops import mxu
from bicubic_interpolation_model_tpu_torch.parallel.mesh import Mesh
from bicubic_interpolation_model_tpu_torch.parallel.spatial import (
    _plan_halo, _row_bands, resize_spatial_sharded)

METHODS = ["nearest", "bilinear", "bicubic", "lanczos"]


def _img(seed, h, w, c):
    return np.random.default_rng(seed).integers(0, 256, (h, w, c),
                                                dtype=np.uint8)


def _d(a, b):
    d = np.abs(np.asarray(a).astype(np.int64) - np.asarray(b).astype(np.int64))
    return d.max(), (d != 0).mean()


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("c", [4, 3])
@pytest.mark.parametrize("n", [2, 4])
def test_both_impls_match_jax_and_the_oracle(method, c, n):
    img = _img(n * 10 + c, 8 * n, 12, c)
    mesh = Mesh(["cpu"] * n, ("spatial",))
    ref = np.asarray(jax_resize_sharded(img, 4, method,
                                        mesh=jax_make_mesh(n, spatial=n)))
    oracle = resize_oracle(img, 4.0, method)
    single = mxu.resize_mxu(img, 4, method, device="cpu")
    for impl in ("einsum", "mxu"):
        got = resize_spatial_sharded(img, 4, method, mesh=mesh, impl=impl)
        assert got.shape == ref.shape == (32 * n, 48, c)
        assert got.dtype == torch.uint8
        assert _d(got, ref)[0] <= 1 and _d(got, oracle)[0] <= 1
    assert torch.equal(got, single)


@pytest.mark.parametrize("c", [4, 3])
def test_mxu_bands_match_jax_mxu_bands(c):
    """The JAX function's per-band Pallas kernel (interpret mode) against
    the port's kernel-C bands: ≤1 LSB (bf16 splits there, f32 here)."""
    img = _img(c, 16, 24, c)
    ref = np.asarray(jax_resize_sharded(img, 4, "bicubic",
                                        mesh=jax_make_mesh(2, spatial=2),
                                        impl="mxu", interpret=True))
    got = resize_spatial_sharded(img, 4, "bicubic",
                                 mesh=Mesh(["cpu"] * 2, ("spatial",)),
                                 impl="mxu")
    assert got.shape == ref.shape and _d(got, ref)[0] <= 1


@pytest.mark.parametrize("method", METHODS)
def test_row_bands_and_halo_equal_the_jax_package(method):
    kw = {"a": -0.5} if method == "bicubic" else (
        {"a": 3} if method == "lanczos" else {})
    plan = planlib.plan_axis(method, 24, 4.0, **kw)
    for n in (2, 4):
        halo = _plan_halo(plan, n)
        assert halo == jax_spatial._plan_halo(plan, n)
        assert np.array_equal(_row_bands(plan, n, halo),
                              jax_spatial._row_bands(plan, n, halo))


def test_auto_takes_the_einsum_bands_on_a_cpu_mesh_and_floats_stay_float():
    img = _img(5, 16, 10, 4)
    mesh = Mesh(["cpu"] * 4, ("spatial",))
    before = mxu.resize_mxu.launches
    assert torch.equal(resize_spatial_sharded(img, 4, mesh=mesh),
                       resize_spatial_sharded(img, 4, mesh=mesh,
                                              impl="einsum"))
    assert mxu.resize_mxu.launches == before
    f = torch.from_numpy(img).float() / 3
    for impl in ("einsum", "mxu"):
        got = resize_spatial_sharded(f, 2, mesh=mesh, impl=impl)
        assert got.dtype == torch.float32
        want = mxu.resize_mxu(f, 2)
        assert float((got - want).abs().max()) < 1e-3


def test_checks():
    mesh = Mesh(["cpu"] * 4, ("spatial",))
    with pytest.raises(ValueError, match="integer"):
        resize_spatial_sharded(_img(0, 16, 8, 3), 2.5, mesh=mesh)
    with pytest.raises(ValueError, match="not divisible"):
        resize_spatial_sharded(_img(0, 18, 8, 3), 2, mesh=mesh)
    with pytest.raises(ValueError, match="impl"):
        resize_spatial_sharded(_img(0, 16, 8, 3), 2, mesh=mesh, impl="gather")
    with pytest.raises(ValueError, match="channels"):
        resize_spatial_sharded(_img(0, 16, 8, 5), 2, mesh=mesh, impl="mxu")
    with pytest.raises(ValueError, match="HWC"):
        resize_spatial_sharded(_img(0, 16, 8, 3)[..., 0], 2, mesh=mesh)
