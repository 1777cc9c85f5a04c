"""The port's adaptive bicubic (bicubic_interpolation_model_tpu_torch/ops/
adaptive.py, both routes) on the CPU against the JAX package's jnp graph and
the float64 oracle; tests/test_torch_adaptive_fused.py holds the kernel's
route against the JAX Pallas kernel in interpret mode.

Inputs come from a NumPy seed. Besides uniform noise (whose 5x5 luma
variance is ~5000: every centre is an edge) the frames below reach all three
region classes and both thresholds: a constant frame (flat), a slow gradient
(variance 10..50: texture), low-amplitude noise (flat and texture), a step
edge (flat beside edge) and a mosaic of these.

Tolerances: every uint8 output ≤1 LSB from ``adaptive_bicubic_oracle`` and
from the JAX jnp graph (f32 sums in another order; the oracle is float64);
the float64 plain version differs from the oracle in under 1e-3 of the bytes
(its weights are float32); ``row_vectors``/``col_vectors`` bit-equal;
``adaptive_gt_factors`` within 1e-6."""

import numpy as np
import pytest
import torch

from bicubic_interpolation_model_tpu.core.oracle import (
    adaptive_bicubic_oracle)
from bicubic_interpolation_model_tpu.ops import adaptive as jadaptive
from bicubic_interpolation_model_tpu.ops import pallas_adaptive as jfused
from bicubic_interpolation_model_tpu_torch.ops import adaptive as tadaptive
from bicubic_interpolation_model_tpu_torch.ops import (
    adaptive_fused as tfused)
from bicubic_interpolation_model_tpu_torch.ops.adaptive import (
    EDGE, FLAT, TEXTURE, adaptive_resize, adaptive_resize_batch)

FRAMES = ["noise", "const", "gradient", "lownoise", "step", "mosaic"]
GEOMETRIES = [(13, 11, 4, 4), (8, 40, 3, 3), (16, 12, 4, 2), (9, 9, 3, 1)]


def all_class_frame(name, h, w, c, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    gray = lambda g: np.stack([g.astype(np.uint8)] * c, -1)
    parts = {
        "noise": rng.integers(0, 256, (h, w, c), dtype=np.uint8),
        "const": np.full((h, w, c), 97, np.uint8),
        "gradient": gray(40 + 2.2 * xx + 1.3 * yy),
        "lownoise": (120 + rng.integers(-6, 7, (h, w, c))).astype(np.uint8),
        "step": gray(np.where(xx < w // 2, 60, 180)),
    }
    if name == "mosaic":
        img = parts["noise"].copy()
        img[:h // 2, :w // 2] = parts["const"][:h // 2, :w // 2]
        img[:h // 2, w // 2:] = parts["gradient"][:h // 2, w // 2:]
        img[h // 2:, :w // 2] = parts["lownoise"][h // 2:, :w // 2]
    else:
        img = parts[name]
    if c == 4:                                   # varying alpha
        img[..., 3] = rng.integers(0, 256, (h, w), dtype=np.uint8)
    return img


def class_counts(img):
    cls = tadaptive.region_classes(
        tadaptive.luma_bt709(torch.from_numpy(img).float())).numpy()
    return {k: int((cls == k).sum()) for k in (TEXTURE, FLAT, EDGE)}


def _max_diff(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return int(np.abs(a.astype(np.int64) - b.astype(np.int64)).max())


def test_frames_reach_every_class_and_both_thresholds():
    counts = {n: class_counts(all_class_frame(n, 24, 28, 4)) for n in FRAMES}
    print(counts)             # per frame: pixels in texture / flat / edge
    assert counts["noise"][EDGE] == 24 * 28
    assert counts["const"][FLAT] == 24 * 28
    assert counts["gradient"][TEXTURE] > 0 and counts["gradient"][EDGE] == 0
    assert counts["lownoise"][FLAT] > 0 and counts["lownoise"][TEXTURE] > 0
    assert counts["step"][FLAT] > 0 and counts["step"][EDGE] > 0
    assert all(v > 0 for v in counts["mosaic"].values())


@pytest.mark.parametrize("name", FRAMES)
@pytest.mark.parametrize("h,w,c,s", GEOMETRIES)
def test_adaptive_matches_oracle_and_jax(h, w, c, s, name):
    img = all_class_frame(name, h, w, c, seed=h + s)
    want = adaptive_bicubic_oracle(img, float(s))
    graph = adaptive_resize(img, s, impl="jnp", device="cpu")
    fused = adaptive_resize(img, s, impl="pallas", device="cpu")
    assert graph.dtype == torch.uint8 and graph.shape == want.shape
    assert _max_diff(graph.numpy(), want) <= 1
    assert _max_diff(fused.numpy(), want) <= 1
    assert torch.equal(adaptive_resize(img, s, device="cpu"), graph)
    jgraph = np.asarray(jadaptive.adaptive_resize(img, s, impl="jnp"))
    assert _max_diff(graph.numpy(), jgraph) <= 1
    assert _max_diff(fused.numpy(), jgraph) <= 1


@pytest.mark.parametrize("h,w,c,s", [(7, 9, 3, 4), (10, 6, 4, 3),
                                     (6, 8, 3, 2), (5, 5, 4, 1),
                                     (3, 4, 3, 5), (2, 2, 4, 4)])
def test_both_routes_match_the_oracle_at_other_shapes(h, w, c, s):
    """The scale and channel pairs the JAX comparison above leaves out, odd
    scales and frames smaller than a tap window."""
    img = all_class_frame("mosaic", h, w, c, seed=h * w)
    want = adaptive_bicubic_oracle(img, float(s))
    for impl in ("jnp", "pallas"):
        got = adaptive_resize(img, s, impl=impl, device="cpu").numpy()
        assert _max_diff(got, want) <= 1, impl


@pytest.mark.parametrize("name", FRAMES)
def test_float64_plain_version_vs_oracle(name):
    h, w, c, s = 14, 19, 4, 4
    img = all_class_frame(name, h, w, c, seed=3)
    t = torch.from_numpy(img)[None]
    wy, wye, wx = tfused._weights(h, w, s, -0.5, t.device, None)
    got = tfused.adaptive_resize_reference(t, wy, wye, wx, s,
                                           dtype=torch.float64)[0].numpy()
    want = adaptive_bicubic_oracle(img, float(s))
    share = float((got != want).mean())
    print(name, "share of bytes differing from the oracle:", share)
    # float64 on both sides; the weights reach the port as float32
    assert _max_diff(got, want) <= 1 and share < 1e-3


@pytest.mark.parametrize("n,s", [(1, 1), (2, 3), (5, 2), (13, 4), (40, 3)])
def test_axis_vectors_bit_equal(n, s):
    for pad in (n, n + 7):
        for got, want in zip(tfused.row_vectors(n, s, -0.5, pad),
                             jfused.row_vectors(n, s, -0.5, pad)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(tfused.col_vectors(n, s, -0.75, pad),
                                      jfused.col_vectors(n, s, -0.75, pad))
    t = np.linspace(-2.5, 2.5, 1001)
    np.testing.assert_array_equal(tadaptive._cubic_memo_np(t, -0.5),
                                  jadaptive._cubic_memo_np(t, -0.5))


@pytest.mark.parametrize("s", [1, 2, 3, 4, 5])
def test_centre_variant_is_round_half_up(s):
    got = [tadaptive.centre_offset(q, s) for q in range(s)]
    assert got == [int(np.floor(q / s + 0.5)) for q in range(s)]
    if s == 3:
        assert got == [0, 0, 1]


def test_batch_equals_per_frame():
    imgs = np.stack([all_class_frame(n, 10, 12, 4, seed=7)
                     for n in ("noise", "mosaic", "gradient")])
    for impl in ("jnp", "pallas", "auto"):
        b = adaptive_resize_batch(imgs, 4, impl=impl, device="cpu")
        assert b.shape == (3, 40, 48, 4) and b.dtype == torch.uint8
        for i in range(3):
            assert torch.equal(b[i], adaptive_resize(imgs[i], 4, impl=impl,
                                                     device="cpu"))
    fb = tfused.adaptive_resize_fused_batch(imgs, 4, device="cpu")
    assert torch.equal(fb, adaptive_resize_batch(imgs, 4, impl="pallas",
                                                 device="cpu"))
    with pytest.raises(ValueError, match=r"\[B, H, W, C\]"):
        tfused.adaptive_resize_fused_batch(imgs[0], 4, device="cpu")
    with pytest.raises(ValueError, match=r"\[B, H, W, C\]"):
        adaptive_resize_batch(imgs[0], 4, device="cpu")


def test_serving_layout_is_hwc_off_the_card():
    img = all_class_frame("mosaic", 9, 10, 4, seed=11)
    out = adaptive_resize(img, 2, layout="auto", device="cpu")
    assert out.dtype == torch.uint8 and out.shape == (18, 20, 4)
    with pytest.raises(ValueError, match="unknown layout"):
        adaptive_resize(img, 2, layout="planar", device="cpu")


def test_more_than_four_channels_take_the_plain_graph():
    """C = 5 takes the plain graph, and the kernel's route refuses it, as
    the JAX Pallas wrapper does; C = 2, which reads its second channel for
    the luma's third, takes both routes and gives the JAX package's frame
    (tests/test_torch_adaptive_gray.py holds C = 1 and 2 in full)."""
    rng = np.random.default_rng(15)
    img = rng.integers(0, 256, (7, 9, 5), dtype=np.uint8)
    got = adaptive_resize(img, 2, device="cpu").numpy()
    assert _max_diff(got, adaptive_bicubic_oracle(img, 2.0)) <= 1
    with pytest.raises(ValueError, match="1 to 4 channels"):
        adaptive_resize(img, 2, impl="pallas", device="cpu")
    want = np.asarray(jadaptive.adaptive_resize(img[..., :2], 2, impl="jnp"))
    for impl in ("auto", "jnp", "pallas"):
        two = adaptive_resize(img[..., :2], 2, impl=impl, device="cpu")
        assert two.shape == (14, 18, 2)
        assert _max_diff(two.numpy(), want) <= 1, impl


def test_fused_takes_every_integer_scale():
    assert tfused.fused_takes(4, 4) and tfused.fused_takes(1, 3)
    assert tfused.fused_takes(15, 3) and tfused.fused_takes(300, 4)
    assert tfused.fused_takes(4, 1) and tfused.fused_takes(17, 2)
    assert not tfused.fused_takes(2.5, 4) and not tfused.fused_takes(0, 4)
    assert not tfused.fused_takes(4, 5) and not tfused.fused_takes(4, 0)
    img = all_class_frame("mosaic", 4, 5, 3)
    # the kernel's route has no scale limit (<= 1 LSB from the oracle)
    big = tfused.adaptive_resize_fused(img, 15, device="cpu").numpy()
    assert big.shape == (60, 75, 3)
    assert _max_diff(big, adaptive_bicubic_oracle(img, 15.0)) <= 1


def test_rejects_bad_arguments():
    img = all_class_frame("noise", 6, 6, 4)
    with pytest.raises(ValueError, match="integer upscale"):
        adaptive_resize(img, 2.5, device="cpu")
    with pytest.raises(ValueError, match="integer upscale"):
        tfused.adaptive_resize_fused(img, 0, device="cpu")
    with pytest.raises(ValueError, match="uint8"):
        adaptive_resize(img.astype(np.float32), 2, device="cpu")
    with pytest.raises(ValueError, match="unknown impl"):
        adaptive_resize(img, 2, impl="bogus", device="cpu")
    with pytest.raises(ValueError, match="expected"):
        adaptive_resize(img[None], 2, device="cpu")
    with pytest.raises(ValueError, match="unknown layout"):
        tfused.adaptive_resize_fused(img, 2, layout="flat", device="cpu")


def test_cpu_tensors_launch_nothing_and_numpy_needs_a_device():
    img = all_class_frame("noise", 6, 6, 4)
    before = tfused.adaptive_resize_fused.launches
    cache = {}
    out = tfused.adaptive_resize_fused(torch.from_numpy(img), 2,
                                       weight_cache=cache)
    assert out.device.type == "cpu" and len(cache) == 1
    tfused.adaptive_resize_fused(torch.from_numpy(img), 2, weight_cache=cache)
    assert len(cache) == 1
    assert tfused.adaptive_resize_fused.launches == before
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tfused.adaptive_resize_fused(img, 2)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            adaptive_resize(img, 2)


@pytest.mark.parametrize("scale", [2, 4])
def test_adaptive_gt_factors(scale):
    rng = np.random.default_rng(17)
    lr = rng.random((9, 11, 3)).astype(np.float32)
    lr[:4, :5] = 0.4                              # a flat patch
    lr[5:, 6:] = lr[5:, 6:] * 0.15 + 0.3          # a texture patch
    got = tadaptive.adaptive_gt_factors(lr, scale, device="cpu")
    want = np.asarray(jadaptive.adaptive_gt_factors(lr, scale))
    assert got.shape == want.shape == (9 * scale, 11 * scale, 16)
    assert np.abs(got.numpy() - want).max() < 1e-6
