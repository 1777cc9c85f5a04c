"""The port's learned-pipeline ops (bicubic_interpolation_model_tpu_torch/
ops/learned.py) against the JAX package's ``ops/learned.py``.

Tolerances: offset maps and GT weights 1e-6 (the same f32 formulas);
apply_weights phase and gather forms 1e-4 before rounding (f32 sums of
products of values up to 255); round-half-even bit-equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bicubic_interpolation_model_tpu.ops import learned as J
from bicubic_interpolation_model_tpu_torch.ops import learned as T


@pytest.mark.parametrize("convention", ["train", "inference"])
@pytest.mark.parametrize("h_sr,w_sr,scale", [(48, 40, 4.0), (36, 27, 3.0)])
def test_offset_map(convention, h_sr, w_sr, scale):
    ref = np.asarray(J.offset_map(h_sr, w_sr, scale, convention))
    got = T.offset_map(h_sr, w_sr, scale, convention, device="cpu").numpy()
    assert got.shape == ref.shape == (h_sr, w_sr, 2)
    assert np.abs(got - ref).max() <= 1e-6


@pytest.mark.parametrize("convention", ["train", "inference"])
def test_gt_weight_map(convention):
    ref = np.asarray(J.gt_weight_map(32, 24, 4.0, convention))
    got = T.gt_weight_map(32, 24, 4.0, convention, device="cpu").numpy()
    assert np.abs(got - ref).max() <= 1e-6


def test_gt_weights_from_random_offsets():
    rng = np.random.default_rng(0)
    dx = rng.uniform(-0.6, 0.6, (50,)).astype(np.float32)
    dy = rng.uniform(-0.6, 0.6, (50,)).astype(np.float32)
    ref = np.asarray(J.gt_weights_from_offsets(jnp.asarray(dx),
                                               jnp.asarray(dy)))
    got = T.gt_weights_from_offsets(torch.as_tensor(dx),
                                    torch.as_tensor(dy)).numpy()
    assert np.abs(got - ref).max() <= 1e-6
    t = np.linspace(-2.5, 2.5, 101).astype(np.float32)
    assert np.abs(T.cubic_keys_jnp(torch.as_tensor(t)).numpy()
                  - np.asarray(J.cubic_keys_jnp(jnp.asarray(t)))).max() <= 1e-6


def test_offset_map_rejects_unknown_convention():
    with pytest.raises(ValueError):
        T.offset_map(8, 8, 4.0, "other", device="cpu")


def _lr_and_weights(rng, h, w, h_sr, w_sr, c=4):
    lr = rng.integers(0, 256, (h, w, c)).astype(np.float32)
    wts = rng.normal(0, 0.3, (h_sr, w_sr, 16)).astype(np.float32)
    return lr, wts


def test_apply_weights_phase_form():
    rng = np.random.default_rng(1)
    lr, wts = _lr_and_weights(rng, 9, 13, 36, 52)
    ref = np.asarray(J._apply_weights_phase(jnp.asarray(lr),
                                            jnp.asarray(wts), 4))
    got = T._apply_weights_phase(torch.as_tensor(lr), torch.as_tensor(wts),
                                 4).numpy()
    assert np.abs(got - ref).max() <= 1e-4


def test_apply_weights_gather_form():
    rng = np.random.default_rng(2)
    lr, wts = _lr_and_weights(rng, 8, 10, 20, 25, c=3)   # scale 2.5
    ref = np.asarray(J._apply_weights_gather(jnp.asarray(lr),
                                             jnp.asarray(wts)))
    got = T._apply_weights_gather(torch.as_tensor(lr),
                                  torch.as_tensor(wts)).numpy()
    assert np.abs(got - ref).max() <= 1e-4


@pytest.mark.parametrize("h,w,h_sr,w_sr", [(9, 13, 36, 52), (8, 10, 20, 25)])
def test_apply_weights_dispatch(h, w, h_sr, w_sr):
    """The public op picks the same form (phase for integer scales, gather
    otherwise); rounded results agree to 1 LSB (an f32 sum may straddle a
    half in one framework and not the other)."""
    rng = np.random.default_rng(3)
    lr = rng.integers(0, 256, (h, w, 4)).astype(np.float32)
    wts = np.asarray(J.gt_weight_map(h_sr, w_sr, h_sr / h))
    ref_f = np.asarray(J.apply_weights(lr, wts, rounded=False))
    got_f = T.apply_weights(lr, torch.as_tensor(wts), rounded=False).numpy()
    assert np.abs(got_f - ref_f).max() <= 1e-4
    got = T.apply_weights(lr, torch.as_tensor(wts)).numpy()
    assert got.dtype == np.int32
    assert np.abs(got - np.asarray(J.apply_weights(lr, wts))).max() <= 1


def test_apply_round_half_even():
    v = np.array([0.5, 1.5, 2.5, 254.5, 255.5, -0.5, 3.49, 3.51, 300.0,
                  -7.0], np.float32)
    ref = np.asarray(J._apply_round(jnp.asarray(v)))
    got = T._apply_round(torch.as_tensor(v)).numpy()
    assert got.dtype == np.int32
    assert np.array_equal(got, ref)
    assert list(got[:6]) == [0, 2, 2, 254, 255, 0]
