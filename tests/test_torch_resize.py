"""The port's ops/resize.py (bicubic_interpolation_model_tpu_torch) on the
CPU against the JAX package's ``resize`` of the same ``impl`` and against
the float64 oracle.

Tolerances: uint8 outputs ≤1 LSB from ``core.oracle.resize_oracle`` with
fewer than 0.5% of bytes differing (the JAX package's own gate), and ≤1 LSB
from the JAX function (both f32; sums in another order); ``nearest`` is
bit-equal; float outputs within 1e-4 absolute on a 0-255 range."""

import numpy as np
import pytest
import torch

from bicubic_interpolation_model_tpu.core.oracle import resize_oracle
from bicubic_interpolation_model_tpu.ops import resize as jresize
from bicubic_interpolation_model_tpu_torch.ops.resize import (
    _as_fraction, resize, resize_batch, round_u8)

METHODS = ["nearest", "bilinear", "bicubic", "lanczos"]


def _image(seed, h, w, c=4):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (h, w, c), dtype=np.uint8)
    if c == 4:
        img[..., 3] = 255
    return img


def _parity(got, want, max_mismatch=5e-3):
    got = np.asarray(got).astype(np.int32)
    want = np.asarray(want).astype(np.int32)
    assert got.shape == want.shape, (got.shape, want.shape)
    d = np.abs(got - want)
    assert d.max() <= 1, f"max u8 delta {d.max()} > 1"
    assert (d != 0).mean() < max_mismatch


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("impl", ["gather", "matmul"])
@pytest.mark.parametrize("scale", [2.0, 4.0, 2.5])
def test_resize_parity(method, impl, scale):
    img = _image(0, 17, 13)
    got = resize(img, scale, method, impl=impl, device="cpu")
    assert isinstance(got, torch.Tensor) and got.dtype == torch.uint8
    _parity(got.numpy(), resize_oracle(img, scale, method))
    ref = np.asarray(jresize.resize(img, scale, method, impl=impl))
    _parity(got.numpy(), ref)
    if method == "nearest":
        np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("scale", [2, 3, 4, 1.5, 2.5, 1.25])
def test_resize_phase_parity(scale):
    img = _image(1, 22, 31)
    got = resize(img, scale, "bicubic", impl="phase", device="cpu").numpy()
    _parity(got, resize_oracle(img, float(scale), "bicubic"))
    _parity(got, np.asarray(jresize.resize(img, scale, "bicubic",
                                           impl="phase")))


def test_resize_auto_picks_valid_impl():
    img = _image(2, 9, 9)
    for scale, method in [(4, "bicubic"), (2.5, "bicubic"), (4, "lanczos")]:
        got = resize(img, scale, method, device="cpu").numpy()
        _parity(got, resize_oracle(img, float(scale), method))


def test_resize_float_roundtrip():
    img = _image(3, 8, 8).astype(np.float32)
    for impl in ("auto", "gather", "matmul", "phase"):
        out = resize(img, 2.0, "bicubic", impl=impl, device="cpu")
        assert out.dtype == torch.float32 and out.shape == (16, 16, 4)
        want = np.asarray(jresize.resize(img, 2.0, "bicubic", impl=impl))
        assert np.abs(out.numpy() - want).max() < 1e-4
    unit = resize(img / 255.0, 2.0, "bicubic", device="cpu")
    assert unit.dtype == torch.float32 and float(unit.max()) < 1.5


def test_resize_2d_grayscale_and_tensor_input():
    img = _image(4, 10, 10)[..., 0].copy()
    out = resize(torch.from_numpy(img), 3.0, "bilinear", device="cpu")
    assert out.shape == (30, 30)
    want = resize_oracle(img[..., None], 3.0, "bilinear")[..., 0]
    _parity(out.numpy(), want)


@pytest.mark.parametrize("impl", ["auto", "gather", "matmul", "pallas_mxu",
                                  "pallas_phase", "pallas"])
def test_resize_batch(impl):
    imgs = np.stack([_image(5 + i, 8, 6) for i in range(3)])
    out = resize_batch(imgs, 2.0, "bicubic", impl=impl, device="cpu")
    assert out.shape == (3, 16, 12, 4)
    for i in range(3):
        _parity(out[i].numpy(), resize_oracle(imgs[i], 2.0, "bicubic"))
        one = resize(imgs[i], 2.0, "bicubic", impl=impl, device="cpu")
        np.testing.assert_array_equal(out[i].numpy(), one.numpy())
    gray = resize_batch(imgs[..., 0], 2.0, "nearest", impl=impl,
                        device="cpu")
    assert gray.shape == (3, 16, 12)


def test_resize_tiny_image_phase_fallback():
    img = _image(6, 2, 2)
    got = resize(img, 4, "bicubic", impl="phase", device="cpu").numpy()
    _parity(got, resize_oracle(img, 4.0, "bicubic"))
    img = _image(7, 3, 4)
    got = resize(img, 1.5, "bicubic", impl="phase", device="cpu").numpy()
    _parity(got, resize_oracle(img, 1.5, "bicubic"))


def test_resize_rejects_bad_args():
    img = _image(8, 4, 4)
    with pytest.raises(ValueError, match="unknown method"):
        resize(img, 2, "bogus", impl="gather", device="cpu")
    with pytest.raises(ValueError, match="unknown impl"):
        resize(img, 2, "bicubic", impl="bogus", device="cpu")
    with pytest.raises(ValueError, match="4-tap"):
        resize(img, 2, "lanczos", impl="phase", device="cpu")
    with pytest.raises(ValueError, match="4-tap"):
        resize(img, 2 ** 0.5, "bicubic", impl="phase", device="cpu")
    with pytest.raises(ValueError, match="dimensions"):
        resize(img[None, None], 2, "bicubic", device="cpu")
    with pytest.raises(ValueError, match="small rational"):
        resize(img, 0.5, "bicubic", impl="pallas_mxu", device="cpu")
    with pytest.raises(ValueError, match="integer upscale"):
        resize(img, 2.5, "bicubic", impl="pallas_phase", device="cpu")


def test_banded_route_takes_integer_scales_only():
    """``impl="pallas"`` is a working route (the banded-matrix kernel's; on
    the CPU its plain version) that takes integer scales only;
    tests/test_torch_banded.py holds it against the JAX kernel."""
    img = _image(9, 4, 4)
    got = resize(img, 2, "bicubic", impl="pallas", device="cpu")
    _parity(got.numpy(), resize_oracle(img, 2.0, "bicubic"))
    with pytest.raises(ValueError, match="integer upscale"):
        resize(img, 2.5, "bicubic", impl="pallas", device="cpu")
    with pytest.raises(ValueError, match="integer upscale"):
        resize_batch(img[None], 1.5, "bicubic", impl="pallas", device="cpu")


def test_needs_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resize(_image(10, 4, 4), 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resize_batch(_image(10, 4, 4)[None], 2)


def test_round_u8_and_as_fraction_match_the_reference():
    v = np.array([-3.0, -0.5, -0.49, 0.49, 0.5, 1.5, 2.5, 254.5, 255.49,
                  300.0], np.float32)
    np.testing.assert_array_equal(round_u8(torch.from_numpy(v)).numpy(),
                                  np.asarray(jresize.round_u8(v)))
    for s in (1.0, 1.5, 2.5, 1.25, 4.0, 2 ** 0.5, 0.5, 65 / 64, 129 / 128):
        assert _as_fraction(s) == jresize._as_fraction(s)
