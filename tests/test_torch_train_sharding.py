"""The port's data x spatial train steps (bicubic_interpolation_model_tpu_
torch/parallel/train_sharding.py) and ``entry.dryrun_multichip`` on the
CPU: each sharded step on a 2 x 2 mesh of the CPU repeated, against the
port's unsharded step and the JAX package's step from the same parameters
and batch, at the tolerances of tests/test_torch_train.py (one step:
parameters rtol 2e-5 / atol 2e-6, the loss ≤1e-6 relative; the JAX loss
against the float64 loss of its forward, as there)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from bicubic_interpolation_model_tpu.models import espcn as jespcn
from bicubic_interpolation_model_tpu.models import srresnet_tpu as jsrres
from bicubic_interpolation_model_tpu.models.weight_predictor import (
    WeightPredictor as JWeightPredictor)
from bicubic_interpolation_model_tpu.train import trainer as jtr
from bicubic_interpolation_model_tpu_torch.entry import dryrun_multichip
from bicubic_interpolation_model_tpu_torch.models import espcn
from bicubic_interpolation_model_tpu_torch.models import srresnet_tpu
from bicubic_interpolation_model_tpu_torch.models.layers import tree_to_numpy
from bicubic_interpolation_model_tpu_torch.models.weight_predictor import (
    WeightPredictor)
from bicubic_interpolation_model_tpu_torch.parallel import train_sharding
from bicubic_interpolation_model_tpu_torch.parallel.mesh import Mesh
from bicubic_interpolation_model_tpu_torch.train import trainer as tr
from test_torch_train import _leaf_diffs, _loss64, _wp_batch, _wp_params

MESH = Mesh([["cpu"] * 2] * 2, ("data", "spatial"))


def _close(tp, ref):
    """The port's tree against another port tree at the one-step
    tolerance."""
    for a, b in zip(jax.tree.leaves(tree_to_numpy(tp)),
                    jax.tree.leaves(tree_to_numpy(ref))):
        np.testing.assert_allclose(a, b, rtol=2e-5, atol=2e-6)


def test_receptive_halo_counts_the_conv_stack():
    assert train_sharding.receptive_halo(WeightPredictor()) == 3
    assert train_sharding.receptive_halo(espcn.ESPCN(features=8)) == 4
    assert train_sharding.receptive_halo(srresnet_tpu.SRResNetTPU(
        features=8, n_blocks=1)) == 5


@pytest.mark.parametrize("partial_mask", [False, True])
def test_sharded_weight_predictor_step_is_the_unsharded_step(partial_mask):
    img, off, y, mask = _wp_batch(np.random.default_rng(11), b=4, p=16,
                                  partial_mask=partial_mask)
    params = _wp_params(2)
    model = WeightPredictor()
    # the JAX step and the float64 loss of its forward
    jm, opt = JWeightPredictor(scale=4), optax.adam(1e-4)
    jp, _, jloss, _ = jtr.make_weight_predictor_step(jm, opt)(
        params, opt.init(params), img, off, y, mask)
    ref64 = _loss64(jm.apply(params, img, off), y, mask)
    # the port's unsharded step
    up = tr.trainable(params, "cpu")
    _, _, uloss, _ = tr.make_weight_predictor_step(model)(
        up, tr.adam(1e-4).init(up), img, off, y, mask)
    # the port's sharded step
    step, shard_batch, replicate = train_sharding.make_sharded_train_step(
        model, MESH)
    sp = replicate(params)
    assert list(sp) == ["cpu"]
    opt_state = tr.adam(1e-4).init(sp)
    batch = shard_batch(img, off, y, mask)
    assert [w.shape[1] for w in batch[0].windows[0]] == [11, 11]
    sp, opt_state, sloss = step(sp, opt_state, *batch)
    assert abs(float(sloss) - float(uloss)) <= 1e-6 * float(uloss)
    assert abs(float(sloss) - ref64) <= 1e-6 * ref64
    assert abs(float(jloss) - ref64) <= 1e-4 * ref64
    _close(sp["cpu"], up)
    assert _leaf_diffs(jp, sp["cpu"])[1] <= 1.0


DIRECT = {
    "srresnet": (lambda: jsrres.SRResNetTPU(features=16, n_blocks=1),
                 lambda: srresnet_tpu.SRResNetTPU(features=16, n_blocks=1)),
    "espcn": (lambda: jespcn.ESPCN(features=16),
              lambda: espcn.ESPCN(features=16)),
}


@pytest.mark.parametrize("name", list(DIRECT))
def test_sharded_direct_step_is_the_unsharded_step(name):
    jnet, net = DIRECT[name][0](), DIRECT[name][1]()
    rng = np.random.default_rng(12)
    lr = rng.random((4, 16, 12, 3), np.float32)
    hr = rng.random((4, 64, 48, 3), np.float32)
    params = jnet.init(jax.random.key(3), jnp.zeros((1, 8, 8, 3)))
    opt = optax.adam(1e-3)
    jp, _, jloss, _ = jtr.make_direct_sr_step(jnet, opt)(
        params, opt.init(params), lr, hr)
    ref64 = _loss64(jnet.apply(params, lr), hr)
    up = tr.trainable(params, "cpu")
    _, _, uloss, _ = tr.make_direct_sr_step(net)(
        up, tr.adam(1e-3).init(up), lr, hr)
    step, shard_batch, replicate = train_sharding.make_sharded_direct_step(
        net, MESH)
    sp = replicate(params)
    sp, _, sloss = step(sp, tr.adam(1e-3).init(sp), *shard_batch(lr, hr))
    assert abs(float(sloss) - float(uloss)) <= 1e-6 * float(uloss)
    assert abs(float(sloss) - ref64) <= 1e-6 * ref64
    assert abs(float(jloss) - ref64) <= 1e-4 * ref64
    _close(sp["cpu"], up)
    assert _leaf_diffs(jp, sp["cpu"])[1] <= 1.0


def test_shard_batch_refuses_an_uneven_split():
    _, shard_batch, _ = train_sharding.make_sharded_direct_step(
        espcn.ESPCN(features=8), MESH)
    with pytest.raises(ValueError, match="does not split"):
        shard_batch(np.zeros((3, 8, 8, 3), np.float32),
                    np.zeros((3, 32, 32, 3), np.float32))


def test_gradients_of_every_copy_are_summed_and_updates_agree():
    """Copies on several devices: each copy's gradient becomes the sum over
    the copies, so every copy takes the same update."""
    base = {"params": {"w": torch.arange(4.0)}}
    params = {k: tr.trainable(base, "cpu") for k in ("a", "b")}
    opt_state = tr.adam(0.1).init(params)
    for k, scale in (("a", 1.0), ("b", 3.0)):
        (params[k]["params"]["w"] * scale).sum().backward()
    train_sharding._all_reduce_grads(params)
    for k in params:
        np.testing.assert_array_equal(params[k]["params"]["w"].grad,
                                      np.full(4, 4.0, np.float32))
    opt_state.step()
    np.testing.assert_array_equal(params["a"]["params"]["w"].detach(),
                                  params["b"]["params"]["w"].detach())


def test_dryrun_multichip_on_the_cpu(capsys):
    dryrun_multichip(4, device="cpu")
    out = capsys.readouterr().out
    assert "dryrun_multichip ok: mesh {'data': 2, 'spatial': 2}" in out
    assert "repeated" in out
