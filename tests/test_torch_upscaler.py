"""The port's ``Upscaler`` (bicubic_interpolation_model_tpu_torch/
serving.py; the classical methods and adaptive bicubic) on the CPU against
the JAX package's ``Upscaler`` and the float64 oracles.

Tolerances: ≤1 u8 LSB from ``resize_oracle`` and from the JAX ``Upscaler``
on the same frames (f32 on both sides, sums in another order; the JAX
``pallas_mxu`` route's compensated-bf16 residual may put up to 2% of bytes
on the other side of a rounding boundary); ``nearest`` bit-equal; bucketed
output equal to unbucketed byte for byte; ``method="adaptive"`` ≤1 u8 LSB
from ``adaptive_bicubic_oracle`` and from the JAX ``Upscaler``."""

import numpy as np
import pytest
import torch

from bicubic_interpolation_model_tpu import serving as jserving
from bicubic_interpolation_model_tpu.core.oracle import (
    adaptive_bicubic_oracle, resize_oracle)
from bicubic_interpolation_model_tpu_torch.bench import configs
from bicubic_interpolation_model_tpu_torch.serving import Upscaler

from test_torch_adaptive import all_class_frame


def _image(seed, h, w, c=4):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (h, w, c), dtype=np.uint8)
    if c == 4:
        img[..., 3] = 255
    return img


def _parity(got, want, max_mismatch=5e-3):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert d.max() <= 1 and (d != 0).mean() < max_mismatch


def test_single():
    up = Upscaler(scale=4, device="cpu")
    img = _image(0, 12, 10)
    out = up(img)
    assert isinstance(out, np.ndarray)
    assert out.shape == (48, 40, 4) and out.dtype == np.uint8
    _parity(out, resize_oracle(img, 4.0, "bicubic"))
    _parity(out, jserving.Upscaler(scale=4)(img))
    dev = up(torch.from_numpy(img), fetch=False)
    assert isinstance(dev, torch.Tensor)
    np.testing.assert_array_equal(dev.numpy(), out)


@pytest.mark.parametrize("method", ["nearest", "bilinear", "bicubic",
                                    "lanczos"])
def test_methods_against_the_reference_upscaler(method):
    img = _image(1, 11, 9)
    out = Upscaler(scale=3, method=method, device="cpu")(img)
    ref = jserving.Upscaler(scale=3, method=method)(img)
    _parity(out, ref)
    _parity(out, resize_oracle(img, 3.0, method))
    if method == "nearest":
        np.testing.assert_array_equal(out, ref)


def test_batch_matches_singles():
    up = Upscaler(scale=2, device="cpu")
    imgs = np.stack([_image(2 + i, 16, 16) for i in range(3)])
    outs = up.batch(imgs)
    assert isinstance(outs, np.ndarray) and outs.shape == (3, 32, 32, 4)
    ref = jserving.Upscaler(scale=2).batch(imgs)
    for i in range(3):
        np.testing.assert_array_equal(outs[i], up(imgs[i]))
        _parity(outs[i], resize_oracle(imgs[i], 2.0, "bicubic"))
        _parity(outs[i], ref[i])
    dev = up.batch(imgs, fetch=False)
    assert isinstance(dev, torch.Tensor) and dev.shape == (3, 32, 32, 4)


def test_stream_keeps_order_across_shapes():
    up = Upscaler(scale=2, method="nearest", device="cpu")
    frames = [_image(5, 8, 8), _image(6, 12, 8), _image(7, 8, 8),
              _image(8, 8, 8)]
    outs = list(up.stream(iter(frames)))
    assert [o.shape for o in outs] == [(16, 16, 4), (24, 16, 4),
                                       (16, 16, 4), (16, 16, 4)]
    for f, o in zip(frames, outs):
        np.testing.assert_array_equal(o, resize_oracle(f, 2.0, "nearest"))


@pytest.mark.parametrize("microbatch", ["auto", 2, None])
def test_stream_microbatch(microbatch):
    up = Upscaler(scale=2, device="cpu")
    frames = ([_image(10 + i, 8, 8) for i in range(3)]
              + [_image(13 + i, 12, 8) for i in range(2)]
              + [_image(15, 8, 8)])
    outs = list(up.stream(frames, microbatch=microbatch))
    ref = list(jserving.Upscaler(scale=2).stream(frames,
                                                 microbatch=microbatch))
    assert len(outs) == len(frames)
    for f, o, r in zip(frames, outs, ref):
        _parity(o, resize_oracle(f, 2.0, "bicubic"))
        _parity(o, r)
        np.testing.assert_array_equal(o, up(f))


def test_microbatch_policy_is_the_reference_value():
    """The threshold is the one the JAX package's rule derives from the
    card's committed curves (results_torch/latency_curve_call*.json), as
    the JAX package's is derived from its chip's."""
    curves = configs.card_curves()
    assert len(curves) == 3
    assert Upscaler.MICROBATCH_THRESHOLD_PX == configs.threshold_from(
        [c["rows"] for c in curves])


def test_bucketed_bit_exact():
    up = Upscaler(scale=4, bucket=16, device="cpu")
    plain = Upscaler(scale=4, device="cpu")
    ref = jserving.Upscaler(scale=4, bucket=16)
    for h, w in [(13, 11), (16, 16), (17, 16), (5, 31)]:
        img = _image(20 + h, h, w)
        out = up(img)
        assert out.shape == (h * 4, w * 4, 4)
        # a CUDA kernel takes its extents at run time: ``bucket`` changes
        # nothing, so bucketed bytes are the unbucketed bytes
        np.testing.assert_array_equal(out, plain(img), err_msg=f"{h}x{w}")
        _parity(out, ref(img))
    img = _image(30, 13, 11)
    _parity(up(img), resize_oracle(img, 4.0, "bicubic"))
    outs = list(up.stream([img, img]))
    np.testing.assert_array_equal(outs[1], up(img))


@pytest.mark.parametrize("method", ["nearest", "bilinear", "lanczos"])
def test_bucketed_methods(method):
    img = _image(31, 11, 9)
    for impl in ("auto", "pallas_phase", "pallas_mxu"):
        up = Upscaler(scale=4, method=method, impl=impl, bucket=8,
                      device="cpu")
        _parity(up(img), resize_oracle(img, 4.0, method))
        np.testing.assert_array_equal(
            up(img), Upscaler(scale=4, method=method, impl=impl,
                              device="cpu")(img))


def test_bucketed_rational_scale_takes_the_exact_route():
    up = Upscaler(scale=2.5, bucket=8, device="cpu")
    img = _image(32, 10, 12)
    out = up(img)
    assert out.shape == (25, 30, 4)
    np.testing.assert_array_equal(out, Upscaler(scale=2.5,
                                                device="cpu")(img))


def test_rational_scale():
    img = _image(33, 16, 20)
    for impl in ("auto", "pallas_mxu"):
        out = Upscaler(scale=2.5, impl=impl, device="cpu")(img)
        assert out.shape == (40, 50, 4)
        _parity(out, resize_oracle(img, 2.5, "bicubic"))
    _parity(out, jserving.Upscaler(scale=2.5, impl="pallas_mxu")(img),
            max_mismatch=2e-2)


def test_mxu_route_forced_single_stream_batch():
    up = Upscaler(scale=4, impl="pallas_mxu", device="cpu")
    img = _image(34, 12, 10)
    out = up(img)
    assert out.shape == (48, 40, 4) and out.dtype == np.uint8
    _parity(out, resize_oracle(img, 4.0, "bicubic"))
    _parity(out, jserving.Upscaler(scale=4, impl="pallas_mxu")(img),
            max_mismatch=2e-2)
    dev = up(img, fetch=False)                 # the device HWC tensor
    assert dev.shape == (48, 40, 4)
    np.testing.assert_array_equal(dev.numpy(), out)
    outs = list(up.stream([img, img]))
    assert all(o.shape == (48, 40, 4) for o in outs)
    np.testing.assert_array_equal(outs[0], out)
    assert len(up._weight_cache) == 1
    imgs = np.stack([_image(35 + i, 16, 16) for i in range(3)])
    b = Upscaler(scale=2, impl="pallas_mxu", device="cpu").batch(imgs)
    assert b.shape == (3, 32, 32, 4)
    for i in range(3):
        _parity(b[i], resize_oracle(imgs[i], 2.0, "bicubic"))
    rgb = _image(38, 9, 7, c=3)
    _parity(up(rgb), resize_oracle(rgb, 4.0, "bicubic"))


def test_phase_route_forced():
    up = Upscaler(scale=4, impl="pallas_phase", device="cpu")
    img = _image(39, 12, 10)
    out = up(img)
    _parity(out, resize_oracle(img, 4.0, "bicubic"))
    _parity(out, jserving.Upscaler(scale=4, impl="pallas_phase")(img))
    imgs = np.stack([img, _image(40, 12, 10)])
    b = up.batch(imgs)
    np.testing.assert_array_equal(b[0], out)
    outs = list(up.stream([img, imgs[1]], microbatch=2))
    np.testing.assert_array_equal(outs[1], b[1])
    assert len(up._weight_cache) == 1          # per-size device weights
    up(_image(41, 9, 10))
    assert len(up._weight_cache) == 2
    with pytest.raises(ValueError, match="integer upscale"):
        Upscaler(scale=2.5, impl="pallas_phase", device="cpu")(img)


@pytest.mark.parametrize("impl", ["auto", "pallas_mxu", "pallas_phase"])
def test_call_batch_and_stream_take_one_route(impl):
    """Every entry point dispatches through ``ops/resize``: the same frames
    give the same bytes by ``__call__``, ``batch`` and ``stream``, gray
    [H, W] frames and frames no kernel takes (C > 4) included."""
    up = Upscaler(scale=2, impl=impl, device="cpu")
    shapes = [(9, 7, 4), (9, 7)]
    if impl == "auto":
        shapes.append((9, 7, 5))
    for i, shape in enumerate(shapes):
        rng = np.random.default_rng(50 + i)
        imgs = rng.integers(0, 256, (3,) + shape, dtype=np.uint8)
        singles = [up(f) for f in imgs]
        assert singles[0].shape == tuple(
            2 * n for n in shape[:2]) + shape[2:]
        b = up.batch(imgs)
        streamed = list(up.stream(list(imgs), microbatch=3))
        for k in range(3):
            np.testing.assert_array_equal(b[k], singles[k])
            np.testing.assert_array_equal(streamed[k], singles[k])
    if impl != "auto":
        with pytest.raises(ValueError, match="channels"):
            up.batch(np.zeros((2, 4, 4, 5), np.uint8))


def _mosaic(seed, h, w, c=4):
    """A frame that reaches all three region classes of adaptive bicubic."""
    img = all_class_frame("mosaic", h, w, c, seed=seed)
    if c == 4:
        img[..., 3] = 255
    return img


def test_adaptive_matches_oracle_and_jax_upscaler():
    """``method="adaptive"`` is served: ≤1 u8 LSB from the float64 oracle
    and from the JAX ``Upscaler`` on a frame of all three region classes,
    with ``bucket`` changing nothing."""
    img = _mosaic(60, 10, 12)
    want = adaptive_bicubic_oracle(img, 4.0)
    ref = jserving.Upscaler(scale=4, method="adaptive")(img)
    for up in (Upscaler(scale=4, method="adaptive", device="cpu"),
               Upscaler(scale=4, method="adaptive", bucket=16, device="cpu")):
        got = up(img)
        assert isinstance(got, np.ndarray) and got.dtype == np.uint8
        assert got.shape == want.shape == (40, 48, 4)
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
        assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1
    np.testing.assert_array_equal(
        got, Upscaler(scale=4, method="adaptive", device="cpu")(img))
    dev = up(torch.from_numpy(img), fetch=False)
    assert isinstance(dev, torch.Tensor) and dev.dtype == torch.uint8
    np.testing.assert_array_equal(dev.numpy(), got)


@pytest.mark.parametrize("impl", ["auto", "pallas_phase", "pallas", "jnp"])
def test_adaptive_call_batch_and_stream_take_one_route(impl):
    """Every entry point hands adaptive frames to ``ops/adaptive``: the same
    frames give the same bytes by ``__call__``, ``batch`` and ``stream``
    (which never groups adaptive frames), RGB and 5-channel frames
    included; ``pallas_phase`` means ``auto``."""
    up = Upscaler(scale=3, method="adaptive", impl=impl, device="cpu")
    shapes = [(9, 7, 4), (9, 7, 3)]
    if impl not in ("pallas",):
        shapes.append((6, 7, 5))
    for i, shape in enumerate(shapes):
        imgs = np.stack([_mosaic(70 + i + k, *shape) for k in range(3)])
        singles = [up(f) for f in imgs]
        assert singles[0].shape == (3 * shape[0], 3 * shape[1], shape[2])
        want = adaptive_bicubic_oracle(imgs[0], 3.0)
        assert np.abs(singles[0].astype(int) - want.astype(int)).max() <= 1
        b = up.batch(imgs)
        assert isinstance(b, np.ndarray) and b.shape == (3,) + want.shape
        assert up.batch(imgs, fetch=False).dtype == torch.uint8
        streamed = list(up.stream(list(imgs), microbatch=3))
        for k in range(3):
            np.testing.assert_array_equal(b[k], singles[k])
            np.testing.assert_array_equal(streamed[k], singles[k])
    if impl == "pallas":
        with pytest.raises(ValueError, match="1 to 4 channels"):
            up(np.zeros((4, 4, 5), np.uint8))
    ref = jserving.Upscaler(scale=3, method="adaptive").batch(imgs[:2])
    assert np.abs(up.batch(imgs[:2]).astype(int)
                  - np.asarray(ref).astype(int)).max() <= 1


def test_adaptive_stream_never_groups_frames(monkeypatch):
    up = Upscaler(scale=2, method="adaptive", device="cpu")
    monkeypatch.setattr(Upscaler, "batch", lambda *a, **k: pytest.fail(
        "stream grouped adaptive frames"))
    frames = [_mosaic(80 + i, 8, 8) for i in range(4)]
    for mode in ("auto", 4, None):
        outs = list(up.stream(iter(frames), microbatch=mode))
        assert len(outs) == 4
        np.testing.assert_array_equal(outs[2], up(frames[2]))
    ref = list(jserving.Upscaler(scale=2, method="adaptive").stream(frames))
    assert np.abs(outs[3].astype(int) - ref[3].astype(int)).max() <= 1


def test_adaptive_rejects_non_integer_scale():
    with pytest.raises(ValueError, match="integer"):
        Upscaler(scale=2.5, method="adaptive", device="cpu")(
            np.zeros((8, 8, 4), np.uint8))
    with pytest.raises(ValueError, match="integer"):
        Upscaler(scale=2.5, method="adaptive", device="cpu").batch(
            np.zeros((2, 8, 8, 4), np.uint8))
    with pytest.raises(ValueError, match="integer"):
        jserving.Upscaler(scale=2.5, method="adaptive")(
            np.zeros((8, 8, 4), np.uint8))


def test_banded_route_forced():
    up = Upscaler(scale=4, impl="pallas", device="cpu")
    img = _image(42, 12, 10)
    out = up(img)
    _parity(out, resize_oracle(img, 4.0, "bicubic"))
    b = up.batch(np.stack([img, _image(43, 12, 10)]))
    np.testing.assert_array_equal(b[0], out)
    assert len(up._weight_cache) == 1          # per-size device bands
    with pytest.raises(ValueError, match="integer upscale"):
        Upscaler(scale=2.5, impl="pallas", device="cpu")(img)


def test_needs_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Upscaler(scale=4)
