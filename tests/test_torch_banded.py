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
    b_row, b_colt, left = next(iter(cache.values()))[:3]
    # tiles of 8 x 32 LR pixels, band windows a multiple of 8 deep
    assert b_row.shape == (2, 16, 16) and b_colt.shape == (1, 40, 64)
    assert left == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            banded.resize_banded(img.numpy(), 2)


# -- the kernel's block ranges and its tensor-core arithmetic ---------------

_TF32_MASK = np.uint32(0xffffe000)


def _tf32_trunc(x):
    return (np.asarray(x, np.float32).view(np.uint32)
            & _TF32_MASK).view(np.float32)


def _tf32_rn(x):
    # the kernel's tf32_rn: round to nearest, ties away from zero
    u = np.asarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & _TF32_MASK).view(np.float32)


def _split(x, rnd):
    x = np.asarray(x, np.float32)
    hi = rnd(x)
    return hi.astype(np.float64), rnd(x - hi).astype(np.float64)


def _mma_sum(acc, a, b, spec):
    # one k8 block into an f32 accumulator: exact products, summed exactly,
    # rounded once (the tensor core's sum of a block)
    return (acc + np.einsum(spec, a, b)).astype(np.float32)


def emulate_kernel_f(img, b_row, b_colt, k_row, k_col, s, left,
                     rnd=_tf32_rn):
    """Kernel F's arithmetic in numpy: per tile the row product over the k8
    blocks of each 16-row slab's range, then the column product per
    16-column slab over its range, both as 3xTF32 (hi*hi into one f32 accumulator,
    the cross terms into another, added at the end; u8 windows exact, so
    their lo is zero), the intermediate split once; u8 sums start at 0.5
    and are floored and clipped."""
    b, h, w, c = img.shape
    n_i, th, kh = b_row.shape
    n_j, kw, tw = b_colt.shape
    sh, sw = th // s, tw // s
    u8 = img.dtype == np.uint8
    xp = np.zeros((b, (n_i - 1) * sh + kh, (n_j - 1) * sw + kw, c),
                  np.float32)
    xp[:, left:left + h, left:left + w] = img
    out = np.zeros((b, n_i * th, n_j * tw, c), np.float32)
    for i in range(n_i):
        for j in range(n_j):
            win = xp[:, i * sh:i * sh + kh, j * sw:j * sw + kw]
            whi, wlo = _split(win.reshape(b, kh, kw * c), rnd)
            tmp = np.zeros((b, th, kw * c), np.float32)
            for ms, (lo, hi) in enumerate(k_row[i]):
                rows = slice(16 * ms, min(th, 16 * ms + 16))
                ahi, alo = _split(b_row[i, rows], rnd)
                big = np.zeros((b, rows.stop - rows.start, kw * c),
                               np.float32)
                small = np.zeros_like(big)
                for kb in range(lo, hi):
                    k = slice(8 * kb, 8 * kb + 8)
                    big = _mma_sum(big, ahi[:, k], whi[:, k], "rk,bkn->brn")
                    small = _mma_sum(small, alo[:, k], whi[:, k],
                                     "rk,bkn->brn")
                    small = _mma_sum(small, ahi[:, k], wlo[:, k],
                                     "rk,bkn->brn")
                tmp[:, rows] = big + small
            thi, tlo = _split(tmp.reshape(b, th, kw, c), rnd)
            for ms, (lo, hi) in enumerate(k_col[j]):
                cols = slice(16 * ms, 16 * ms + 16)
                bhi, blo = _split(b_colt[j][:, cols], rnd)
                big = np.full((b, th, 16, c), 0.5 if u8 else 0.0, np.float32)
                small = np.zeros_like(big)
                for kb in range(lo, hi):
                    k = slice(8 * kb, 8 * kb + 8)
                    spec = "brkc,kn->brnc"
                    big = _mma_sum(big, thi[:, :, k], bhi[k], spec)
                    small = _mma_sum(small, tlo[:, :, k], bhi[k], spec)
                    small = _mma_sum(small, thi[:, :, k], blo[k], spec)
                out[:, i * th:(i + 1) * th,
                    j * tw + 16 * ms:j * tw + 16 * ms + 16] = big + small
    out = out[:, :h * s, :w * s]
    if u8:
        return np.clip(np.floor(out), 0, 255).astype(np.uint8)
    return out


def _kernel_operands(method, h, w, s, lanczos_a=3):
    b_row, b_colt, left, k_row, k_col, kbc = banded._bands(
        method, h, w, s, -0.5, lanczos_a, "cpu", None)
    return (b_row.numpy(), b_colt.numpy(), left, k_row.numpy(),
            k_col.numpy(), kbc)


@pytest.mark.parametrize("method,lanczos_a", [
    ("nearest", 3), ("bilinear", 3), ("bicubic", 3), ("lanczos", 3),
    ("lanczos", 2)])
@pytest.mark.parametrize("scale", [1, 2, 3, 4])
def test_block_ranges_cover_every_nonzero_weight(method, lanczos_a, scale):
    """Per 16-row slab of B_row and 16-column slab of B_colT the range runs
    from the first k8 block with a non-zero weight to the last: every
    non-zero weight lies inside it, and its end blocks hold one."""
    for h, w in [(23, 37), (13, 9), (40, 70), (1, 2)]:
        b_row, b_colt, _, k_row, k_col, kbc = _kernel_operands(
            method, h, w, scale, lanczos_a)
        assert k_row.dtype == k_col.dtype == np.int32
        assert k_row.shape == (b_row.shape[0], -(-b_row.shape[1] // 16), 2)
        assert k_col.shape == (b_colt.shape[0], b_colt.shape[2] // 16, 2)
        assert kbc == max(1, int((k_col[..., 1] - k_col[..., 0]).max()))
        for bands, ranges, slab in ((b_row, k_row, 16),
                                    (b_colt.transpose(0, 2, 1), k_col, 16)):
            assert bands.shape[2] % 8 == 0
            for t in range(bands.shape[0]):
                for sl, (lo, hi) in enumerate(ranges[t]):
                    part = bands[t, slab * sl:slab * (sl + 1)]
                    cols = np.nonzero(part.any(axis=0))[0]
                    if cols.size == 0:
                        assert (lo, hi) == (0, 0)
                        continue
                    assert lo == cols[0] // 8 and hi == cols[-1] // 8 + 1
        # every output row and column that exists has a non-empty range
        n_rows = h * scale
        assert all(k_row[r // b_row.shape[1], (r % b_row.shape[1]) // 16, 1]
                   > 0 for r in range(n_rows))


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("scale", [2, 3, 4])
def test_block_skipped_product_equals_the_plain_version(method, scale):
    """The kernel's arithmetic (3xTF32 over the ranged k8 blocks only)
    against the dense f32 plain version: nearest bit-equal, the others
    ≤1 LSB with a share of differing bytes below 1e-3."""
    worst = 0.0
    for (h, w, c), seed in [((23, 37, 4), 1), ((40, 70, 3), 2),
                            ((13, 9, 1), 3), ((7, 5, 6), 4)]:
        img = np.random.default_rng(seed + scale).integers(
            0, 256, (2, h, w, c), dtype=np.uint8)
        b_row, b_colt, left, k_row, k_col, _ = _kernel_operands(
            method, h, w, scale)
        got = emulate_kernel_f(img, b_row, b_colt, k_row, k_col, scale,
                               left)
        want = banded.resize_banded_reference(
            torch.from_numpy(img), torch.from_numpy(b_row),
            torch.from_numpy(b_colt), scale, left).numpy()
        d = np.abs(got.astype(np.int32) - want.astype(np.int32))
        assert d.max() <= 1
        if method == "nearest":
            assert d.max() == 0
        worst = max(worst, float((d != 0).mean()))
    assert worst < 1e-3


def test_block_skipped_product_of_float_input():
    img = np.random.default_rng(5).uniform(0, 255, (1, 19, 35, 4)).astype(
        np.float32)
    for method in METHODS:
        b_row, b_colt, left, k_row, k_col, _ = _kernel_operands(
            method, 19, 35, 3)
        got = emulate_kernel_f(img, b_row, b_colt, k_row, k_col, 3, left)
        want = banded.resize_banded_reference(
            torch.from_numpy(img), torch.from_numpy(b_row),
            torch.from_numpy(b_colt), 3, left).numpy()
        assert np.abs(got - want).max() < 1e-3


def test_truncating_split_misses_the_share():
    """Why the kernel rounds its splits to nearest: truncated hi/lo parts
    bias every term toward zero, and edge sums that lie exactly half-way
    (weights renormalised at the border) then round down where f32 rounds
    up, at more than the 1e-3 of the bytes the card tests allow."""
    img = np.random.default_rng(15).integers(0, 256, (2, 13, 9, 1),
                                             dtype=np.uint8)
    b_row, b_colt, left, k_row, k_col, _ = _kernel_operands(
        "bicubic", 13, 9, 2)
    want = banded.resize_banded_reference(
        torch.from_numpy(img), torch.from_numpy(b_row),
        torch.from_numpy(b_colt), 2, left).numpy().astype(np.int32)
    shares = {}
    for name, rnd in (("trunc", _tf32_trunc), ("rn", _tf32_rn)):
        got = emulate_kernel_f(img, b_row, b_colt, k_row, k_col, 2, left,
                               rnd=rnd)
        shares[name] = float((got.astype(np.int32) != want).mean())
    assert shares["trunc"] > 1e-3 > shares["rn"]
