"""The port's WeightPredictor and PixelShuffleUpsample against the flax
modules of the JAX package, on the committed checkpoints and on random
weights made by numpy from a seed.

Tolerance: 1e-4 in tanh-weight space at f32 (the same function, with
convolutions summed in another order by another library)."""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bicubic_interpolation_model_tpu.evaluation.model_analysis import (
    _load_model_any as jax_load_model_any)
from bicubic_interpolation_model_tpu.models.layers import (
    PixelShuffleUpsample as JaxPixelShuffleUpsample)
from bicubic_interpolation_model_tpu.models.weight_predictor import (
    WeightPredictor as JaxWeightPredictor)
from bicubic_interpolation_model_tpu.models.weight_predictor import (
    init_params as jax_init_params)
from bicubic_interpolation_model_tpu.ops.learned import (
    offset_map as jax_offset_map)
from bicubic_interpolation_model_tpu_torch.models.zoo import load_model
from bicubic_interpolation_model_tpu_torch.models.layers import (
    PixelShuffleUpsample, pixel_shuffle_upsample)
from bicubic_interpolation_model_tpu_torch.models.weight_predictor import (
    LAYERS, WeightPredictor, forward_params, init_params, params_from_jax)

MODEL_DIR = pathlib.Path(__file__).resolve().parents[1] / "model"


@pytest.mark.parametrize("name", ["wp-1e-3-120", "wp-adaptive-1e-3-120"])
def test_weight_predictor_forward_matches_flax(name):
    jmodel, jparams = jax_load_model_any(str(MODEL_DIR / name))
    model, params = load_model(MODEL_DIR / name, device="cpu")
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 1, (2, 12, 10, 4)).astype(np.float32)
    off = np.asarray(jax_offset_map(48, 40, 4.0, "train"))
    off = np.broadcast_to(off, (2,) + off.shape).copy()
    ref = np.asarray(jmodel.apply(jparams, jnp.asarray(img), jnp.asarray(off)))
    with torch.no_grad():
        got = model(torch.as_tensor(img), torch.as_tensor(off)).numpy()
        got_fn = forward_params(params["params"], torch.as_tensor(img),
                                torch.as_tensor(off)).numpy()
    assert got.shape == ref.shape == (2, 48, 40, 16)
    assert np.abs(got - ref).max() <= 1e-4
    assert np.array_equal(got, got_fn)


def test_pixel_shuffle_upsample_matches_flax():
    rng = np.random.default_rng(2)
    x = rng.normal(0, 1, (2, 5, 7, 32)).astype(np.float32)
    k = rng.normal(0, 0.2, (4, 4, 16, 32)).astype(np.float32)
    b = rng.normal(0, 0.2, (16,)).astype(np.float32)
    ref = np.asarray(JaxPixelShuffleUpsample(16, 4).apply(
        {"params": {"kernel": k, "bias": b}}, jnp.asarray(x)))
    got = pixel_shuffle_upsample(torch.as_tensor(x), torch.as_tensor(k),
                                 torch.as_tensor(b)).numpy()
    assert got.shape == ref.shape == (2, 20, 28, 16)
    assert np.abs(got - ref).max() <= 1e-5
    layer = PixelShuffleUpsample(16, 4, 32)
    assert tuple(layer.kernel.shape) == (4, 4, 16, 32)


def test_init_params_matches_flax_tree_shapes():
    _, jvars = jax_init_params(jax.random.key(0), scale=4)
    model, params = init_params(torch.Generator().manual_seed(0),
                                device="cpu")
    assert set(params["params"]) == set(jvars["params"]) == set(LAYERS)
    for layer in LAYERS:
        for k in ("kernel", "bias"):
            assert tuple(params["params"][layer][k].shape) == \
                jvars["params"][layer][k].shape
    # the tree is the module's own parameters
    assert params["params"]["conv_out"]["kernel"] is model.conv_out.kernel


def test_init_params_is_seeded():
    a = init_params(torch.Generator().manual_seed(3), device="cpu")[1]
    b = init_params(torch.Generator().manual_seed(3), device="cpu")[1]
    c = init_params(torch.Generator().manual_seed(4), device="cpu")[1]
    ka, kb, kc = (t["params"]["conv_in"]["kernel"] for t in (a, b, c))
    assert torch.equal(ka, kb) and not torch.equal(ka, kc)


def test_random_weights_carry_across():
    """Random numpy weights in the flax tree → the port via params_from_jax:
    both forwards agree."""
    _, jvars = jax_init_params(jax.random.key(5), scale=4)
    model = WeightPredictor().load_tree(jax.device_get(jvars))
    rng = np.random.default_rng(5)
    img = rng.uniform(0, 1, (1, 9, 11, 4)).astype(np.float32)
    off = np.asarray(jax_offset_map(36, 44, 4.0, "inference"))[None]
    ref = np.asarray(JaxWeightPredictor(scale=4).apply(jvars, img, off))
    with torch.no_grad():
        got = model(torch.as_tensor(img), torch.as_tensor(off)).numpy()
    assert np.abs(got - ref).max() <= 1e-4


def test_load_tree_rejects_wrong_shapes():
    _, jvars = jax_init_params(jax.random.key(0), scale=4)
    tree = jax.device_get(jvars)
    tree["params"]["conv_out"]["kernel"] = np.zeros((3, 3, 32, 8),
                                                    np.float32)
    with pytest.raises(ValueError):
        WeightPredictor().load_tree(tree)


def test_load_model_any_rejects_unported_models(tmp_path):
    """Since the direct branch is ported, only what no ModelUpscaler
    serves is refused: the MLP predictors (loaded by
    models.mlp_predictor.load_mlp) and unknown ``meta["model"]`` names."""
    for name in ("patch-mlp", "pixel-mlp"):
        with pytest.raises(ValueError, match="load_mlp"):
            load_model(MODEL_DIR / name, device="cpu")
    (tmp_path / "params.msgpack").write_bytes(
        (MODEL_DIR / "wp-1e-3-120" / "params.msgpack").read_bytes())
    (tmp_path / "meta.json").write_text('{"model": "NoSuchModel"}')
    with pytest.raises(ValueError, match="NoSuchModel"):
        load_model(tmp_path, device="cpu")
    model, _ = load_model(MODEL_DIR / "espcn_medium", device="cpu")
    assert type(model).__name__ == "ESPCN"


def test_entry_points_need_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_model(MODEL_DIR / "wp-1e-3-120")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_jax(jax.device_get(jax_init_params(
            jax.random.key(0), scale=4)[1]))
