"""The port's banded-matrix resize (bicubic_interpolation_model_tpu_torch/
ops/banded.py; on the CPU the kernel's plain version) against the JAX
package's ``resize_pallas`` in interpret mode and the float64 oracle.

Tolerances: uint8 outputs ≤1 LSB from ``resize_oracle`` with fewer than
0.5% of bytes differing (the JAX package's own gate) and ≤1 LSB from the JAX
kernel (both f32 at full precision; sums in another order); ``nearest``
bit-equal; float outputs within 1e-4 absolute on a 0-255 range; ``_banded``
bit-equal."""

import numpy as np
import pytest
import torch

from bicubic_interpolation_model_tpu.core import plan as jplan
from bicubic_interpolation_model_tpu.core.oracle import resize_oracle
from bicubic_interpolation_model_tpu.ops import pallas_resize as jbanded
from bicubic_interpolation_model_tpu_torch.core import plan as tplan
from bicubic_interpolation_model_tpu_torch.ops import banded
from bicubic_interpolation_model_tpu_torch.ops.resize import (
    resize, resize_batch)

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
def test_banded_parity_small(method):
    img = _image(0, 24, 18)
    want = resize_oracle(img, 4.0, method)
    got = resize(img, 4, method, impl="pallas", device="cpu")
    assert got.dtype == torch.uint8 and got.shape == want.shape
    _parity(got.numpy(), want)
    assert torch.equal(got, banded.resize_banded(img, 4, method,
                                                 device="cpu"))
    ref = np.asarray(jbanded.resize_pallas(img, 4, method, tile_h=32,
                                           tile_w=256, interpret=True))
    _parity(got.numpy(), ref)
    if method == "nearest":
        np.testing.assert_array_equal(got.numpy(), ref)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("scale", [1, 2, 3])
def test_banded_parity_scales(scale):
    img = _image(1, 33, 20)
    got = banded.resize_banded(img, scale, "bicubic", device="cpu").numpy()
    _parity(got, resize_oracle(img, float(scale), "bicubic"))
    _parity(got, np.asarray(jbanded.resize_pallas(
        img, scale, "bicubic", tile_h=24, tile_w=384, interpret=True)))


def test_banded_multi_tile():
    # several tiles in each grid dimension (a tile is 16 x 32 LR pixels)
    img = _image(2, 40, 70, c=3)
    got = banded.resize_banded(img, 4, "bicubic", device="cpu").numpy()
    _parity(got, resize_oracle(img, 4.0, "bicubic"))
    _parity(got, np.asarray(jbanded.resize_pallas(
        img, 4, "bicubic", tile_h=64, tile_w=128, interpret=True)))


@pytest.mark.parametrize("lanczos_a", [2, 3])
def test_banded_lanczos_window(lanczos_a):
    img = _image(3, 19, 35)
    got = banded.resize_banded(img, 2, "lanczos", lanczos_a=lanczos_a,
                               device="cpu").numpy()
    _parity(got, resize_oracle(img, 2.0, "lanczos", a=lanczos_a))


def test_banded_float_input():
    img = _image(4, 16, 16).astype(np.float32)
    out = banded.resize_banded(img, 2, "bicubic", device="cpu")
    assert out.dtype == torch.float32 and out.shape == (32, 32, 4)
    ref = np.asarray(jbanded.resize_pallas(img, 2, "bicubic", tile_h=16,
                                           tile_w=256, interpret=True))
    assert np.abs(out.numpy() - ref).max() < 1e-4
    want = resize_oracle(img.astype(np.uint8), 2.0, "bicubic")
    _parity(np.clip(np.floor(out.numpy() + 0.5), 0, 255), want)
    half = banded.resize_banded(torch.from_numpy(img).half(), 2, "bilinear")
    assert half.dtype == torch.float16


def test_banded_gray_batch_and_wide_frames():
    img = _image(5, 10, 12)
    gray = resize(img[..., 0], 3, "bilinear", impl="pallas", device="cpu")
    assert gray.shape == (30, 36)
    _parity(gray.numpy(), resize_oracle(img[..., :1], 3.0, "bilinear")[..., 0])
    imgs = np.stack([_image(6 + i, 8, 6) for i in range(3)])
    out = resize_batch(imgs, 2, "bicubic", impl="pallas", device="cpu")
    assert out.shape == (3, 16, 12, 4)
    for i in range(3):
        assert torch.equal(out[i], resize(imgs[i], 2, "bicubic",
                                          impl="pallas", device="cpu"))
    gb = resize_batch(imgs[..., 0], 2, "nearest", impl="pallas",
                      device="cpu")
    assert gb.shape == (3, 16, 12)
    rng = np.random.default_rng(9)
    six = rng.integers(0, 256, (7, 9, 6), dtype=np.uint8)   # a plane each
    _parity(banded.resize_banded(six, 2, device="cpu").numpy(),
            resize_oracle(six, 2.0, "bicubic"))


def test_banded_rejects_what_the_kernel_does_not_take():
    img = _image(7, 8, 8)
    with pytest.raises(ValueError, match="integer upscale"):
        banded.resize_banded(img, 2.5, device="cpu")
    with pytest.raises(ValueError, match="integer upscale"):
        resize(img, 2.5, "bicubic", impl="pallas", device="cpu")
    with pytest.raises(ValueError, match="integer upscale"):
        banded.resize_banded(img, 0, device="cpu")
    with pytest.raises(ValueError, match="unknown method"):
        banded.resize_banded(img, 2, "adaptive", device="cpu")
    with pytest.raises(ValueError, match="HW, HWC or BHWC"):
        banded.resize_banded(img[None, None], 2, device="cpu")


@pytest.mark.parametrize("method,n_in,scale,tile,k_pad,left", [
    ("bicubic", 33, 4, 64, 24, 1), ("bicubic", 5, 3, 24, 16, 1),
    ("lanczos", 20, 2, 32, 24, 2), ("nearest", 17, 4, 64, 24, 0),
    ("bilinear", 40, 1, 16, 24, 0)])
def test_banded_slices_bit_equal(method, n_in, scale, tile, k_pad, left):
    got = banded._banded(tplan.plan_axis(method, n_in, float(scale)), tile,
                         k_pad, left)
    want = jbanded._banded(jplan.plan_axis(method, n_in, float(scale)), tile,
                           k_pad, left)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert banded._LEFT_EXTENT == jbanded._LEFT_EXTENT


def test_cpu_tensors_launch_nothing_and_bands_are_cached():
    img = torch.from_numpy(_image(8, 9, 9))
    before = banded.resize_banded.launches
    cache = {}
    banded.resize_banded(img, 2, weight_cache=cache)
    banded.resize_banded(img, 2, weight_cache=cache)
    assert len(cache) == 1 and banded.resize_banded.launches == before
    b_row, b_colt, left = next(iter(cache.values()))
    assert b_row.shape == (1, 32, 20) and b_colt.shape == (1, 36, 64)
    assert left == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            banded.resize_banded(img.numpy(), 2)
