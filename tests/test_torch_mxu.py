"""The port's ops/mxu.py (the wrapper of CUDA kernel C and its plain
PyTorch version) on the CPU against the JAX package's ``resize_mxu`` run in
interpret mode with small tiles, as tests/test_pallas_mxu.py runs it, and
against the float64 oracle.

Tolerances: ≤1 u8 LSB from ``resize_oracle`` (the framework's contract) and
≤1 LSB from the JAX kernel, whose compensated-bf16 products leave a residual
of ~0.004, so a small share of bytes (under 2%) may sit on the other side of
a rounding boundary; ``nearest`` is bit-equal; float inputs within 1e-4
absolute of the f64 plain version on a 0-255 range (the JAX kernel's
bf16-split float path is held to 2e-2)."""

import functools

import numpy as np
import pytest
import torch

from bicubic_interpolation_model_tpu.core.oracle import resize_oracle
from bicubic_interpolation_model_tpu.ops import pallas_mxu as jmxu
from bicubic_interpolation_model_tpu_torch.ops import mxu

METHODS = ["nearest", "bilinear", "bicubic", "lanczos"]

# numpy frames go to the card unless the caller asks for the CPU
resize_mxu = functools.partial(mxu.resize_mxu, device="cpu")


def _image(seed, h, w, c=4):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (h, w, c), dtype=np.uint8)
    if c == 4:
        img[..., 3] = 255
    return img


def _delta(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    d = np.abs(got.astype(np.int64) - want.astype(np.int64))
    return int(d.max()), float((d != 0).mean())


def _check(img, scale, method, jax_kw, **kw):
    got = resize_mxu(img, scale, method, **kw)
    assert got.device.type == "cpu"
    assert isinstance(got, torch.Tensor) and got.dtype == torch.uint8
    okw = {"a": kw["lanczos_a"]} if "lanczos_a" in kw else {}
    assert _delta(got.numpy(), resize_oracle(img, scale, method, **okw))[0] <= 1
    ref = np.asarray(jmxu.resize_mxu(img, scale, method, **jax_kw, **kw))
    mx, share = _delta(got.numpy(), ref)
    assert mx <= 1 and share < 2e-2
    if method == "nearest":
        assert mx == 0
    return got


@pytest.mark.parametrize("method,scale", [
    ("bicubic", 4.0), ("bicubic", 2.0), ("bicubic", 3.0),
    ("bilinear", 4.0), ("nearest", 4.0), ("lanczos", 4.0)])
def test_integer_scales_parity(method, scale):
    _check(_image(0, 23, 37), scale, method, dict(step_in=8, wstep=32))


@pytest.mark.parametrize("method,scale", [
    ("bicubic", 1.5), ("bicubic", 2.5), ("bicubic", 1.25),
    ("lanczos", 1.5), ("bilinear", 2.5), ("nearest", 1.5)])
def test_rational_scales_parity(method, scale):
    _check(_image(1, 40, 64), scale, method, dict(step_in=8, wstep=64))


@pytest.mark.parametrize("c", [1, 2, 3, 4])
def test_channel_counts(c):
    img = _image(2, 16, 24)[..., :c].copy()
    _check(img, 4.0, "bicubic", dict(step_in=8, wstep=32))


def test_lanczos_window_and_cubic_parameter():
    img = _image(3, 16, 24)
    a2 = _check(img, 2.0, "lanczos", dict(step_in=8, wstep=64), lanczos_a=2)
    a3 = resize_mxu(img, 2.0, "lanczos")
    assert (a2 != a3).any()
    got = resize_mxu(img, 2.0, "bicubic", a=-0.75)
    assert _delta(got.numpy(), resize_oracle(img, 2.0, "bicubic",
                                             a=-0.75))[0] <= 1


def test_gray_2d_roundtrip():
    img = _image(4, 16, 24)[..., 0].copy()
    got = resize_mxu(img, 2.0, "bicubic")
    assert got.shape == (32, 48)
    want = resize_oracle(img[..., None], 2.0, "bicubic")[..., 0]
    assert _delta(got.numpy(), want)[0] <= 1


def test_flat_layout_views_as_hwc():
    img = _image(5, 23, 37)
    flat = resize_mxu(img[None], 4.0, "bicubic", layout="flat").numpy()
    assert flat.shape == (1, 92, 148 * 4) and flat.dtype == np.uint8
    view = mxu.flat_to_hwc_np(flat[0], 92, 148, 4)
    assert view.base is not None           # a view, not a copy
    np.testing.assert_array_equal(
        view, resize_mxu(img, 4.0, "bicubic").numpy())
    assert mxu.flat_to_hwc_np(flat[0], 92, 148, 4, out_c=3).shape == (
        92, 148, 3)
    # the helper reads strides, so the JAX form's padded frames view too
    jflat = np.asarray(jmxu.resize_mxu(img[None], 4.0, "bicubic", step_in=8,
                                       wstep=32, layout="flat"))
    assert _delta(mxu.flat_to_hwc_np(jflat[0], 92, 148, 4), view)[0] <= 1
    with pytest.raises(ValueError, match="BHWC"):
        resize_mxu(img, 4.0, "bicubic", layout="flat")
    with pytest.raises(ValueError, match="unknown layout"):
        resize_mxu(img[None], 4.0, "bicubic", layout="planar")


def test_batch_equals_singles_and_weight_cache():
    imgs = np.stack([_image(6 + i, 13, 9) for i in range(3)])
    cache = {}
    out = resize_mxu(imgs, 2.5, "bicubic", weight_cache=cache)
    assert out.shape == (3, 33, 23, 4)
    for i in range(3):
        one = resize_mxu(imgs[i], 2.5, "bicubic", weight_cache=cache)
        assert torch.equal(out[i], one)
    assert len(cache) == 1
    resize_mxu(_image(9, 12, 9), 2.5, "bicubic", weight_cache=cache)
    assert len(cache) == 2                 # per-size plans


def test_float_passthrough():
    img = _image(10, 12, 10).astype(np.float32)
    out = resize_mxu(img, 2.0, "bicubic")
    assert out.dtype == torch.float32 and out.shape == (24, 20, 4)
    cache = {}
    resize_mxu(torch.from_numpy(img), 2.0, "bicubic", weight_cache=cache)
    ops = next(iter(cache.values()))
    f64 = mxu.resize_mxu_reference(torch.from_numpy(img)[None], *ops[:4],
                                   dtype=torch.float64)[0]
    assert float((out - f64).abs().max()) < 1e-4
    ref = np.asarray(jmxu.resize_mxu(img, 2.0, "bicubic", step_in=8,
                                     wstep=64))
    assert np.abs(out.numpy() - ref).max() < 2e-2
    want = resize_oracle(img.astype(np.uint8), 2.0, "bicubic")
    rounded = np.clip(np.floor(out.numpy() + 0.5), 0, 255)
    assert _delta(rounded, want)[0] <= 1


def test_support_predicates_equal_the_reference():
    scales = [0.5, 0.75, 1, 1.0, 1.1, 1.25, 4 / 3, 1.5, 1.75, 2, 2.5, 3,
              3.2, 4, 4.0 + 1e-12, 4.001, 17 / 16, 33 / 32, 8, 16, 2 ** 0.5]
    for s in scales:
        assert mxu.scale_fraction(s) == jmxu.scale_fraction(s), s
        for c in (0, 1, 2, 3, 4, 5):
            for method in METHODS + ["adaptive"]:
                assert (mxu.mxu_supported(s, c, method)
                        == jmxu.mxu_supported(s, c, method)), (s, c, method)


def test_kernel_takes_more_than_the_reference_tiler():
    """``mxu_takes`` is what routes on the card: everything the JAX
    predicate takes, and the scales its tiler refuses."""
    for s in (1, 1.25, 1.5, 2.5, 4, 17 / 16, 16):
        for c in (1, 2, 3, 4):
            for method in METHODS:
                assert mxu.mxu_takes(s, c, method)
                assert mxu.mxu_takes(s, c, method) >= mxu.mxu_supported(
                    s, c, method)
    assert not mxu.mxu_supported(17 / 16, 1, "bicubic")
    for s, c, method in [(0.5, 4, "bicubic"), (2 ** 0.5, 4, "bicubic"),
                         (33 / 32, 4, "bicubic"), (2, 5, "bicubic"),
                         (2, 0, "bicubic"), (2, 4, "adaptive")]:
        assert not mxu.mxu_takes(s, c, method)
    img = _image(12, 20, 18)[..., 0].copy()
    got = resize_mxu(img, 17 / 16, "bicubic")
    assert _delta(got.numpy(), resize_oracle(img[..., None], 17 / 16,
                                             "bicubic")[..., 0])[0] <= 1


def test_numpy_goes_to_the_card_and_tensors_run_where_they_lie():
    img = _image(13, 8, 8)
    t = torch.from_numpy(img)
    assert mxu.resize_mxu(t, 2, "bicubic").device.type == "cpu"
    assert torch.equal(mxu.resize_mxu(t, 2, "bicubic"),
                       resize_mxu(img, 2, "bicubic"))
    if torch.cuda.is_available():
        assert mxu.resize_mxu(img, 2, "bicubic").is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            mxu.resize_mxu(img, 2, "bicubic")


def test_downscale_and_bad_shapes_rejected():
    img = _image(11, 8, 8)
    with pytest.raises(ValueError, match="small rational"):
        resize_mxu(img, 0.5, "bicubic")
    with pytest.raises(ValueError, match="small rational"):
        resize_mxu(img, 2 ** 0.5, "bicubic")
    with pytest.raises(ValueError, match="channels"):
        resize_mxu(np.zeros((4, 4, 5), np.uint8), 2, "bicubic")
    with pytest.raises(ValueError, match="HW, HWC or BHWC"):
        resize_mxu(np.zeros((1, 1, 4, 4, 4), np.uint8), 2, "bicubic")
    with pytest.raises(ValueError, match="unknown method"):
        resize_mxu(img, 2, "adaptive")


def test_tile_windows_cover_every_tap():
    """The windows the kernel stages come from the plan: every tap of a
    tile's outputs lies in the tile's window [lo, lo + extent), and the
    bands it reads are the plan densified per group of 4 outputs."""
    from bicubic_interpolation_model_tpu_torch.core import plan as planlib
    for method in METHODS:
        for scale in (1.0, 1.25, 1.5, 2.5, 4.0):
            p = planlib.plan_axis(method, 300, scale)
            band, lo, tile_lo, extent = mxu._axis_operands(p.idx, p.w, 32)
            n_t = -(-p.n_out // 32)
            assert tile_lo.dtype == np.int32 and len(tile_lo) == n_t
            assert band.shape == (n_t, band.shape[1], 8, 4)
            for t in range(n_t):
                rows = p.idx[t * 32:(t + 1) * 32]
                assert rows.min() == tile_lo[t]
                assert rows.max() < tile_lo[t] + extent
                assert (lo[t * 8:(t + 1) * 8] + band.shape[1]
                        <= tile_lo[t] + extent).all()
            dense = np.zeros((n_t * 32, 300 + band.shape[1]))
            for g in range(n_t * 8):
                dense[g * 4:g * 4 + 4, lo[g]:lo[g] + band.shape[1]] = (
                    band[g // 8, :, g % 8, :].T)
            np.testing.assert_allclose(dense[:p.n_out, :300],
                                       planlib.plan_to_matrix(p), atol=1e-7)
            assert not dense[p.n_out:].any() and not dense[:, 300:].any()


def _banded_pass(x, band, lo, n_out, axis):
    """One pass as kernel C sums it: per output, its group's dense weights
    over the group's window, in input order (zero weights past the image)."""
    width = band.shape[1]
    b = band.permute(0, 2, 1, 3).reshape(-1, width, 4)      # [n_g, width, 4]
    shape = [1] * x.dim()
    shape[axis] = n_out
    acc = None
    for j in range(width):
        idx = (lo.long()[:, None] + j).expand(-1, 4).reshape(-1)[:n_out]
        term = (b[:, j, :].reshape(-1)[:n_out].reshape(shape)
                * x.index_select(axis, idx.clamp(max=x.shape[axis] - 1)))
        acc = term if acc is None else acc + term
    return acc


def banded_resize(img_bhwc, ops):
    """Kernel C's arithmetic on the CPU in f32 (row pass first), from the
    operands ``_operands`` gives it; the wrapper's rounding."""
    band_y, lo_y, _, band_x, lo_x, _, _, _, ho, wo = ops[4:]
    tmp = _banded_pass(img_bhwc.float(), band_y, lo_y, ho, 1)
    out = _banded_pass(tmp, band_x, lo_x, wo, 2)
    if img_bhwc.dtype == torch.uint8:
        return torch.clamp(torch.trunc(out + 0.5), 0, 255).to(torch.uint8)
    return out


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("scale", [1, 1.25, 2.5, 3, 4])
def test_banded_sum_matches_the_plain_version_and_oracle(method, scale):
    """The bands' order of summation (each output's taps in input order,
    duplicate clamped taps summed first) stays within 1 u8 LSB of the plain
    version and of the float64 oracle, and ``nearest`` bit-equal; float
    inputs within 1e-3."""
    for h, w, c in [(23, 37, 4), (13, 9, 3), (40, 70, 1)]:
        img = torch.from_numpy(_image(h * w + c, h, w, c))[None]
        ops = mxu._operands(method, h, w, scale, -0.5, 3, "cpu", None)
        got = banded_resize(img, ops)
        ref = mxu.resize_mxu_reference(img, *ops[:4])
        mx, share = _delta(got[0].numpy(), ref[0].numpy())
        assert mx <= (0 if method == "nearest" else 1) and share < 1e-3
        assert _delta(got[0].numpy(), mxu.resize_mxu_reference(
            img, *ops[:4], dtype=torch.float64)[0].numpy())[0] <= 1
        gf = banded_resize(img.float(), ops)
        assert float((gf - mxu.resize_mxu_reference(
            img.float(), *ops[:4])).abs().max()) < 1e-3


def test_bands_of_a_plan_slice_give_the_same_bytes():
    """Band-sharded kernel C builds bands from a slice of the global row
    plan whose groups need not line up with the frame's; each output's sum
    is its taps in input order either way, so the bytes are the same."""
    from bicubic_interpolation_model_tpu_torch.core import plan as planlib
    img = torch.from_numpy(_image(7, 30, 20, 4))[None]
    full = banded_resize(img, mxu._operands("lanczos", 30, 20, 2.5, -0.5, 3,
                                            "cpu", None))
    p = planlib.plan_axis("lanczos", 30, 2.5, a=3)
    for start in (3, 26, 41):
        sl = p.idx[start:]
        lo = int(sl.min())
        band, glo, _, _ = mxu._axis_operands(sl - lo, p.w[start:], 32)
        tmp = _banded_pass(img[:, lo:].float(), torch.from_numpy(band),
                           torch.from_numpy(glo), p.n_out - start, 1)
        ops = mxu._operands("lanczos", 30, 20, 2.5, -0.5, 3, "cpu", None)
        part = _banded_pass(tmp, ops[7], ops[8], ops[13], 2)
        part = torch.clamp(torch.trunc(part + 0.5), 0, 255).to(torch.uint8)
        assert torch.equal(part, full[:, start:])
