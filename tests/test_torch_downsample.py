"""The port's antialiased downsample (bicubic_interpolation_model_tpu_torch/
ops/downsample.py) on the CPU against the JAX package's.

Tolerances: uint8 outputs ≤1 LSB from the JAX ``downsample`` (both f32 at
full precision; sums in another order), float outputs within 1e-4 absolute
on a 0-255 range, ``downsample_np`` (NumPy float64 on both sides)
bit-equal."""

import numpy as np
import pytest
import torch

from bicubic_interpolation_model_tpu.ops import downsample as jdown
from bicubic_interpolation_model_tpu_torch.ops.downsample import (
    downsample, downsample_np)


def _image(seed, h, w, c=3):
    return np.random.default_rng(seed).integers(0, 256, (h, w, c),
                                                dtype=np.uint8)


@pytest.mark.parametrize("method", ["cubic", "lanczos3", "bicubic",
                                    "triangle"])
@pytest.mark.parametrize("factor", [2, 4, 2.5])
def test_downsample_matches_the_reference(method, factor):
    img = _image(0, 41, 37)
    got = downsample(img, factor, method, device="cpu")
    want = np.asarray(jdown.downsample(img, factor, method))
    assert got.dtype == torch.uint8 and got.shape == want.shape
    d = np.abs(got.numpy().astype(int) - want.astype(int))
    assert d.max() <= 1 and (d != 0).mean() < 5e-3
    np.testing.assert_array_equal(downsample_np(img, factor, method),
                                  jdown.downsample_np(img, factor, method))
    host = downsample_np(img, factor, method).astype(int)
    assert np.abs(got.numpy().astype(int) - host).max() <= 1


@pytest.mark.parametrize("method", ["cubic", "lanczos3"])
def test_downsample_float_gray_and_out_shape(method):
    img = _image(1, 32, 48).astype(np.float32)
    got = downsample(img, 4, method, device="cpu")
    want = np.asarray(jdown.downsample(img, 4, method))
    assert got.dtype == torch.float32 and got.shape == (8, 12, 3)
    assert np.abs(got.numpy() - want).max() < 1e-4
    np.testing.assert_array_equal(downsample_np(img, 4, method),
                                  jdown.downsample_np(img, 4, method))
    gray = downsample(torch.from_numpy(img[..., 0]), 4, method, device="cpu")
    assert gray.shape == (8, 12)
    assert np.abs(gray.numpy() - want[..., 0]).max() < 1e-4
    shaped = downsample(img.astype(np.uint8), 3, method, out_shape=(11, 15),
                        device="cpu")
    ref = np.asarray(jdown.downsample(img.astype(np.uint8), 3, method,
                                      out_shape=(11, 15)))
    assert shaped.shape == (11, 15, 3)
    assert np.abs(shaped.numpy().astype(int) - ref.astype(int)).max() <= 1
    np.testing.assert_array_equal(
        downsample_np(img[..., 0], 3, method, out_shape=(11, 15)),
        jdown.downsample_np(img[..., 0], 3, method, out_shape=(11, 15)))


def test_downsample_rounds_half_up_and_rejects_upscales():
    img = np.array([[0, 1], [0, 1]], np.uint8)          # the mean is 0.5
    assert int(downsample(img, 2, "box", device="cpu")[0, 0]) == 1
    assert int(downsample_np(img, 2, "box")[0, 0]) == 1
    with pytest.raises(ValueError, match="factor"):
        downsample(img, 0.5, device="cpu")


def test_needs_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        downsample(_image(2, 8, 8), 2)


@pytest.mark.parametrize("method", ["cubic", "lanczos3"])
def test_downsample_builds_its_matrices_once_per_shape(method, monkeypatch):
    """Two calls at one shape build the two sampling plans once (the JAX
    package's matrices are constants of its jitted program, built once per
    shape), and both calls give the JAX ``downsample``'s bytes."""
    from bicubic_interpolation_model_tpu_torch.core import plan as planlib
    from bicubic_interpolation_model_tpu_torch.ops import downsample as tdown
    tdown._matrices.cache_clear()
    built = []
    real = planlib.plan_downsample
    monkeypatch.setattr(planlib, "plan_downsample",
                        lambda *a, **k: built.append(a) or real(*a, **k))
    img = _image(3, 52, 44, 4)
    want = np.asarray(jdown.downsample(img, 4, method))
    for i in range(2):
        got = downsample(img ^ np.uint8(i), 4, method, device="cpu")
        np.testing.assert_array_equal(
            got.numpy(), want if i == 0 else np.asarray(
                jdown.downsample(img ^ np.uint8(i), 4, method)))
    assert len(built) == 2
    downsample(_image(4, 52, 40, 4), 4, method, device="cpu")
    assert len(built) == 4                     # another width: two more
