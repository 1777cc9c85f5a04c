"""The port's band-sharded learned SR (bicubic_interpolation_model_tpu_torch/
parallel/spatial.learned_resize_spatial_sharded) against the JAX package's
on its 8-device CPU mesh, on the committed ``model/wp-1e-3-120`` checkpoint
loaded by both packages, frames made by numpy from a seed.

The port's mesh repeats the CPU device n times; its bands run kernel G's
plain version (``tail="kernel"``) or the graph tail. Tolerances, those of
tests/test_parallel.py: ≤1 u8 LSB against the JAX function with the same
tail (the JAX ``"pallas"`` tail is the port's ``"kernel"``), ≤1 against the
single-frame ``super_resolve`` with the graph tail and ≤2 across tails."""

import pathlib

import numpy as np
import pytest
import torch

from bicubic_interpolation_model_tpu.evaluation.model_analysis import (
    _load_model_any as jax_load_model_any)
from bicubic_interpolation_model_tpu.parallel.mesh import (
    make_mesh as jax_make_mesh)
from bicubic_interpolation_model_tpu.parallel.spatial import (
    learned_resize_spatial_sharded as jax_learned_sharded)
from bicubic_interpolation_model_tpu_torch.models.zoo import load_model
from bicubic_interpolation_model_tpu_torch.models.inference import (
    super_resolve)
from bicubic_interpolation_model_tpu_torch.ops.packed_tail import packed_tail
from bicubic_interpolation_model_tpu_torch.parallel.mesh import Mesh
from bicubic_interpolation_model_tpu_torch.parallel.spatial import (
    learned_resize_spatial_sharded)

CKPT = pathlib.Path(__file__).resolve().parents[1] / "model" / "wp-1e-3-120"


@pytest.fixture(scope="module")
def jax_wp():
    return jax_load_model_any(str(CKPT))


@pytest.fixture(scope="module")
def port_wp():
    return load_model(CKPT, device="cpu")


def _frame(seed, h=16, w=20, c=4):
    img = np.random.default_rng(seed).integers(0, 256, (h, w, c),
                                               dtype=np.uint8)
    if c == 4:
        img[..., 3] = 255
    return img


def _d(a, b):
    d = np.abs(np.asarray(a).astype(np.int64) - np.asarray(b).astype(np.int64))
    return d.max(), (d != 0).mean()


@pytest.mark.parametrize("n", [2, 4])
def test_matches_jax_with_each_tail(jax_wp, port_wp, n):
    img = _frame(n)
    jmesh = jax_make_mesh(n, spatial=n)
    mesh = Mesh(["cpu"] * n, ("spatial",))
    for jtail, tail in (("auto", "graph"), ("pallas", "kernel")):
        ref = np.asarray(jax_learned_sharded(*jax_wp, img, 4, mesh=jmesh,
                                             tail=jtail))
        got = learned_resize_spatial_sharded(*port_wp, img, 4, mesh=mesh,
                                             tail=tail)
        assert got.shape == ref.shape == (64, 80, 4)
        assert got.dtype == torch.uint8 and got.device.type == "cpu"
        mx, share = _d(got, ref)
        assert mx <= 1 and share < 1e-3


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("opaque", [True, False])
def test_matches_single_frame_super_resolve(port_wp, n, opaque):
    img = _frame(10 + n, 24, 18)
    if not opaque:
        img[..., 3] = _frame(20 + n, 24, 18)[..., 0]
    mesh = Mesh(["cpu"] * n, ("spatial",))
    single = super_resolve(*port_wp, img, convention="train", tail="graph")
    graph = learned_resize_spatial_sharded(*port_wp, img, 4, mesh=mesh,
                                           tail="graph")
    kernel = learned_resize_spatial_sharded(*port_wp, img, 4, mesh=mesh,
                                            tail="kernel")
    assert _d(graph, single)[0] <= 1
    assert _d(kernel, single)[0] <= 2
    assert _d(kernel, graph)[0] <= 1
    assert float(kernel.float().std()) > 0


def test_auto_tail_on_a_cpu_mesh_is_the_graph(port_wp):
    img = _frame(3)
    mesh = Mesh(["cpu"] * 2, ("spatial",))
    before = packed_tail.launches
    auto = learned_resize_spatial_sharded(*port_wp, img, 4, mesh=mesh)
    graph = learned_resize_spatial_sharded(*port_wp, img, 4, mesh=mesh,
                                           tail="graph")
    assert torch.equal(auto, graph) and packed_tail.launches == before


def test_checks_of_the_jax_function(port_wp):
    mesh = Mesh(["cpu"] * 4, ("spatial",))
    with pytest.raises(ValueError, match="not divisible"):
        learned_resize_spatial_sharded(*port_wp, _frame(0, 18, 8), 4,
                                       mesh=mesh)
    with pytest.raises(ValueError, match="at least 3 rows"):
        learned_resize_spatial_sharded(*port_wp, _frame(0, 8, 8), 4,
                                       mesh=mesh)
    with pytest.raises(ValueError, match="WeightPredictor"):
        learned_resize_spatial_sharded(object(), port_wp[1], _frame(0), 4,
                                       mesh=mesh)
    with pytest.raises(ValueError, match="tail"):
        learned_resize_spatial_sharded(*port_wp, _frame(0), 4, mesh=mesh,
                                       tail="pallas")
    five = np.concatenate([_frame(0), _frame(1)[..., :1]], axis=-1)
    with pytest.raises(ValueError, match="c <= 4"):
        learned_resize_spatial_sharded(*port_wp, five, 4, mesh=mesh,
                                       tail="kernel")
    with pytest.raises(ValueError, match="no axis"):
        learned_resize_spatial_sharded(*port_wp, _frame(0), 4, mesh=mesh,
                                       axis="data")


def test_bands_on_the_other_axis_of_a_2d_mesh(port_wp):
    """On a (data x spatial) mesh the bands take the spatial axis's devices
    at data index 0; the other row would only repeat the work."""
    img = _frame(4)
    grid = Mesh([["cpu", "cpu"], ["cpu", "cpu"]], ("data", "spatial"))
    line = Mesh(["cpu"] * 2, ("spatial",))
    assert torch.equal(
        learned_resize_spatial_sharded(*port_wp, img, 4, mesh=grid),
        learned_resize_spatial_sharded(*port_wp, img, 4, mesh=line))
