"""The port's data-parallel batch resize (bicubic_interpolation_model_tpu_
torch/parallel/batch.py) against the JAX package's on its 8-device CPU mesh,
and the port's device mesh (parallel/mesh.py) against the JAX package's
shape rules.

Tolerances: the batch ≤1 u8 LSB from the JAX function (its Pallas phase
kernel in interpret mode, bf16 splits there, f32 here) and byte-equal to
the port's single-call ``resize_phase`` on the same frames."""

import numpy as np
import pytest
import torch

from bicubic_interpolation_model_tpu.parallel.batch import (
    resize_batch_sharded as jax_batch_sharded)
from bicubic_interpolation_model_tpu.parallel.mesh import (
    make_mesh as jax_make_mesh)
from bicubic_interpolation_model_tpu_torch.ops.phase import resize_phase
from bicubic_interpolation_model_tpu_torch.parallel.batch import (
    resize_batch_sharded)
from bicubic_interpolation_model_tpu_torch.parallel.mesh import (
    Mesh, _grid, make_mesh)


def _imgs(seed, b, h, w, c):
    return np.random.default_rng(seed).integers(0, 256, (b, h, w, c),
                                                dtype=np.uint8)


@pytest.mark.parametrize("method", ["bicubic", "lanczos"])
def test_batch_matches_jax_and_the_single_call(method):
    imgs = _imgs(1, 8, 16, 12, 4)
    ref = np.asarray(jax_batch_sharded(imgs, 4, method,
                                       mesh=jax_make_mesh(4, spatial=1)))
    mesh = Mesh(["cpu"] * 4, ("data",))
    got = resize_batch_sharded(imgs, 4, method, mesh=mesh)
    assert got.shape == ref.shape == (8, 64, 48, 4)
    assert got.dtype == torch.uint8 and got.device.type == "cpu"
    assert np.abs(got.numpy().astype(np.int64)
                  - ref.astype(np.int64)).max() <= 1
    assert torch.equal(got, resize_phase(imgs, 4, method, device="cpu"))


def test_batch_rejects_what_the_jax_function_rejects():
    mesh = Mesh(["cpu"] * 4, ("data",))
    with pytest.raises(ValueError, match="not divisible"):
        resize_batch_sharded(_imgs(0, 3, 8, 8, 4), 4, mesh=mesh)
    with pytest.raises(ValueError):
        jax_batch_sharded(_imgs(0, 3, 8, 8, 4), 4,
                          mesh=jax_make_mesh(4, spatial=1))
    with pytest.raises(ValueError, match="integer"):
        resize_batch_sharded(_imgs(0, 4, 8, 8, 4), 2.5, mesh=mesh)
    with pytest.raises(ValueError, match="B, H, W, C"):
        resize_batch_sharded(_imgs(0, 4, 8, 8, 4)[0], 2, mesh=mesh)


@pytest.mark.parametrize("n", [8, 4, 2, 1])
def test_mesh_shapes_follow_the_jax_rule(n):
    """``make_mesh``'s spatial default on n devices: the JAX package's
    shapes (8 → 4x2, 4 → 2x2, 2 → 2x1, 1 → 1x1)."""
    want = jax_make_mesh(n).shape
    assert _grid([torch.device("cpu")] * n, ("data", "spatial"),
                 None).shape == dict(want)
    assert _grid([torch.device("cpu")] * n, ("data", "spatial"),
                 1).shape == {"data": n, "spatial": 1}


def test_make_mesh_counts_visible_devices_and_never_repeats_one():
    assert make_mesh(1, device_type="cpu").shape == {"data": 1,
                                                     "spatial": 1}
    assert make_mesh(device_type="cpu").shape == {"data": 1, "spatial": 1}
    with pytest.raises(ValueError, match="1 cpu device"):
        make_mesh(2, device_type="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        _grid([torch.device("cpu")] * 6, ("data", "spatial"), 4)
    with pytest.raises(ValueError, match="device type"):
        make_mesh(1, device_type="tpu")
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="0 cuda device"):
            make_mesh()


def test_mesh_axes_and_devices():
    grid = Mesh([["cpu", "cpu", "cpu"], ["cpu", "cpu", "cpu"]],
                ("data", "spatial"))
    assert grid.shape == {"data": 2, "spatial": 3}
    assert grid.axis_devices("spatial") == [torch.device("cpu")] * 3
    assert grid.axis_devices("data") == [torch.device("cpu")] * 2
    with pytest.raises(ValueError, match="no axis"):
        grid.axis_devices("model")
    with pytest.raises(ValueError, match="axis names"):
        Mesh(["cpu", "cpu"], ("data", "spatial"))
