"""The port's adaptive bicubic on 1- and 2-channel uint8 frames (gray, gray
and alpha) on the CPU against the JAX package, on the all-class frames of
tests/test_torch_adaptive.py.

The JAX package indexes the luma's channels with jnp's clamping, so a frame
of C < 3 channels reads channel min(i, C - 1) for channel i; its NumPy
oracle refuses C < 3, so here its jnp graph is the reference. The kernel's
route (``impl="pallas"``, kernel E's plain version on the CPU) is held to
the JAX Pallas kernel in tests/test_torch_adaptive_gray_pallas_c{1,2}.py,
the band-sharded path in tests/test_torch_parallel_adaptive_gray.py.

Tolerances: every uint8 output ≤1 LSB from JAX ``adaptive_resize`` with
``impl="jnp"`` (both f32; the sums are the same but a product may round
differently; 0 is what they give); region classes equal; the planar words
unpacked equal to the hwc bytes, with 0 above the C channel bytes;
``adaptive_gt_factors`` within 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bicubic_interpolation_model_tpu.ops import adaptive as jadaptive
from bicubic_interpolation_model_tpu.ops import pallas_adaptive as jfused
from bicubic_interpolation_model_tpu_torch.ops import adaptive as tadaptive
from bicubic_interpolation_model_tpu_torch.ops import (
    adaptive_fused as tfused)
from bicubic_interpolation_model_tpu_torch.ops.adaptive import (
    EDGE, FLAT, TEXTURE, adaptive_resize, adaptive_resize_batch)
from bicubic_interpolation_model_tpu_torch.serving import Upscaler

from test_torch_adaptive import FRAMES, _max_diff, all_class_frame

SIZES = [(13, 11), (8, 40), (24, 70)]
SCALES = [1, 2, 3, 4]
CHANNELS = [1, 2]


def jax_adaptive(img, s):
    return np.asarray(jadaptive.adaptive_resize(img, s, impl="jnp"))


def jax_classes(img):
    """The JAX package's region classes of an [H, W, C] uint8 frame (its
    graph computes them inline: edge above 50, flat below 10)."""
    var = np.asarray(jadaptive._variance5x5(jadaptive.luma_bt709(
        jnp.asarray(img, jnp.float32))))
    return np.where(var > 50.0, EDGE, np.where(var < 10.0, FLAT, TEXTURE))


def check_against_pallas(h, w, c, s):
    """Kernel E's route on the CPU against the JAX Pallas kernel in
    interpret mode, every all-class frame: ≤1 LSB, on all LR cells but the
    last row and column where a frame leaves the edge class (there the
    JAX kernel reads a centre's class from an unclamped window, ROADMAP
    C.3; test_every_impl_matches_jax holds the port to the jnp graph on
    every cell)."""
    for name in FRAMES:
        img = all_class_frame(name, h, w, c, seed=h + s + c)
        fused = tfused.adaptive_resize_fused(img, s, device="cpu").numpy()
        jkernel = np.asarray(jfused.adaptive_resize_pallas(
            img, s, step=8, wstep=16, interpret=True))
        assert fused.shape == jkernel.shape == (h * s, w * s, c)
        inner = (slice(0, (h - 1) * s), slice(0, (w - 1) * s))
        region = (slice(None), slice(None)) if name == "noise" else inner
        assert _max_diff(fused[region], jkernel[region]) <= 1, name


@pytest.mark.parametrize("c", CHANNELS)
def test_gray_frames_reach_every_class(c):
    counts = {}
    for name in FRAMES:
        cls = tadaptive.region_classes(tadaptive.luma_bt709(
            torch.from_numpy(all_class_frame(name, 24, 28, c)).float()))
        counts[name] = {k: int((cls == k).sum()) for k in (TEXTURE, FLAT,
                                                            EDGE)}
    print(counts)
    assert counts["noise"][EDGE] == 24 * 28
    assert counts["const"][FLAT] == 24 * 28
    assert counts["gradient"][TEXTURE] > 0 and counts["gradient"][EDGE] == 0
    assert counts["lownoise"][FLAT] > 0 and counts["lownoise"][TEXTURE] > 0
    assert counts["step"][FLAT] > 0 and counts["step"][EDGE] > 0
    assert all(v > 0 for v in counts["mosaic"].values())


def test_luma_reads_the_last_channel_for_the_missing_ones():
    """The three-term sum in its order, not a shortcut: a gray value v
    gives (v*0.2126 + v*0.7152) + v*0.0722 in f32, which is not v for
    every v; the bytes of 3 and 4 channels are what they were."""
    v = torch.arange(256, dtype=torch.float32)
    gray = tadaptive.luma_bt709(v[:, None])
    assert torch.equal(gray, (v * 0.2126 + v * 0.7152) + v * 0.0722)
    assert not torch.equal(gray, v)
    two = torch.stack([v, v.flip(0)], -1)
    assert torch.equal(tadaptive.luma_bt709(two), tadaptive.luma_bt709(
        torch.stack([v, v.flip(0), v.flip(0)], -1)))
    rgba = torch.rand(5, 7, 4) * 255
    assert torch.equal(tadaptive.luma_bt709(rgba), tadaptive.luma_bt709(
        rgba[..., :3]))
    for c in (1, 2, 3):
        x = rgba[..., :c]
        np.testing.assert_array_equal(
            tadaptive.luma_bt709(x).numpy(),
            np.asarray(jadaptive.luma_bt709(jnp.asarray(x.numpy()))))


@pytest.mark.parametrize("name", FRAMES)
@pytest.mark.parametrize("s", SCALES)
@pytest.mark.parametrize("h,w", SIZES)
@pytest.mark.parametrize("c", CHANNELS)
def test_every_impl_matches_jax(c, h, w, s, name):
    img = all_class_frame(name, h, w, c, seed=h + s + c)
    want = jax_adaptive(img, s)
    for impl in ("auto", "jnp", "pallas"):
        got = adaptive_resize(img, s, impl=impl, device="cpu")
        assert got.dtype == torch.uint8 and got.shape == want.shape
        assert _max_diff(got.numpy(), want) <= 1, impl
    np.testing.assert_array_equal(
        tadaptive.region_classes(tadaptive.luma_bt709(
            torch.from_numpy(img).float())).numpy(), jax_classes(img))


@pytest.mark.parametrize("s", SCALES)
@pytest.mark.parametrize("h,w", SIZES)
@pytest.mark.parametrize("c", CHANNELS)
def test_batch_and_upscaler_match_jax(c, h, w, s):
    frames = np.stack([all_class_frame(n, h, w, c, seed=h * s + c)
                       for n in ("mosaic", "step", "lownoise")])
    want = [jax_adaptive(f, s) for f in frames]
    up = Upscaler(scale=s, method="adaptive", device="cpu")
    for impl in ("auto", "jnp", "pallas"):
        got = adaptive_resize_batch(frames, s, impl=impl, device="cpu")
        assert got.shape == (3, h * s, w * s, c)
        for k in range(3):
            assert _max_diff(got[k].numpy(), want[k]) <= 1, impl
    called = [up(f) for f in frames]
    batched = up.batch(frames)
    streamed = list(up.stream(list(frames)))
    assert len(streamed) == 3
    for k in range(3):
        for got in (called[k], batched[k], streamed[k]):
            assert isinstance(got, np.ndarray) and got.dtype == np.uint8
            assert _max_diff(got, want[k]) <= 1


@pytest.mark.parametrize("s", SCALES)
@pytest.mark.parametrize("h,w", SIZES)
@pytest.mark.parametrize("c", CHANNELS)
def test_planar_words_hold_the_channels_and_zeros(c, h, w, s):
    img = all_class_frame("mosaic", h, w, c, seed=h + s)
    hwc = tfused.adaptive_resize_fused(img, s, device="cpu")
    planar = tfused.adaptive_resize_fused(img, s, layout="planar",
                                          device="cpu")
    assert planar.dtype == torch.uint32 and planar.shape == (s, h * s, w)
    assert torch.equal(tfused.unpack_planar(planar, h, w, s, c), hwc)
    assert int(planar.numpy().max()) < 2 ** (8 * c)   # bytes above C: 0
    assert _max_diff(hwc.numpy(), jax_adaptive(img, s)) <= 1
    with pytest.raises(ValueError, match="4 channels"):
        tfused.adaptive_resize_fused(img, s, layout="hwc32", device="cpu")
    # the serving layout keeps bytes for frames of fewer than 4 channels
    assert torch.equal(adaptive_resize(img, s, layout="auto", device="cpu"),
                       hwc)


@pytest.mark.parametrize("scale", [2, 4])
@pytest.mark.parametrize("c", CHANNELS)
def test_adaptive_gt_factors_on_gray_frames(c, scale):
    rng = np.random.default_rng(17 + c)
    lr = rng.random((9, 11, c)).astype(np.float32)
    lr[:4, :5] = 0.4                              # a flat patch
    lr[5:, 6:] = lr[5:, 6:] * 0.15 + 0.3          # a texture patch
    got = tadaptive.adaptive_gt_factors(lr, scale, device="cpu")
    want = np.asarray(jadaptive.adaptive_gt_factors(lr, scale))
    assert got.shape == want.shape == (9 * scale, 11 * scale, 16)
    assert np.abs(got.numpy() - want).max() < 1e-6
