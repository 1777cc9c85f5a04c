"""The CUDA kernels of the port (csrc/packed_tail.cu, csrc/interleave.cu,
csrc/resize_mxu.cu, csrc/resize_phase.cu) against their plain PyTorch
versions, and the wrapper contract around them.

This file imports nothing of JAX, so it also runs on a machine with a card
and no JAX: ``python -m pytest --noconftest -m cuda tests/test_torch_kernels.py``.
Tests marked ``cuda`` skip without a card (a CUDA kernel has no CPU mode).

Tolerances on the card, kernel vs plain version: kernel A ≤1 u8 LSB with a
share of differing bytes < 1e-3 at f32 and with opaque alpha, ≤2 LSB with
bf16 features (sums in another order); kernel B bit-equal (a copy);
kernels C and D ≤1 u8 LSB from their plain versions at f32 (nvcc contracts
a*b+c to FMA, PyTorch does not) with a share of differing bytes < 1e-3, and
≤1 LSB from the plain versions at float64; ``nearest`` bit-equal; float
inputs within 1e-3 absolute on a 0-255 range."""

import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from bicubic_interpolation_model_tpu_torch.models.inference import (
    _tail_operands)
from bicubic_interpolation_model_tpu_torch.ops import interleave as ilv
from bicubic_interpolation_model_tpu_torch.ops import mxu, phase
from bicubic_interpolation_model_tpu_torch.ops import packed_tail as pt

ROOT = pathlib.Path(__file__).resolve().parents[1]
GEOMETRIES = [(24, 40, 4), (19, 37, 4), (13, 9, 3), (8, 128, 1),
              (348, 510, 4)]


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _tail_args(h, w, c, seed, device="cpu", opaque=False):
    """Random tail inputs made by numpy from a seed."""
    rng = np.random.default_rng(seed)
    n = lambda *s: torch.as_tensor(rng.normal(0, 0.25, s).astype(np.float32),
                                   device=device)
    p = {"upsample": {"kernel": n(4, 4, 16, 32), "bias": n(16)},
         "conv_att": {"kernel": n(1, 1, 16, 1), "bias": n(1)},
         "conv_off": {"kernel": n(1, 1, 2, 16), "bias": n(16)},
         "conv_out": {"kernel": n(3, 3, 32, 16) * 0.4, "bias": n(16)}}
    y = torch.as_tensor(rng.normal(0, 0.5, (h, w, 32)).astype(np.float32),
                        device=device)
    lr = rng.integers(0, 256, (h, w, c)).astype(np.float32)
    if opaque:
        lr[..., 3] = 255.0
    return (y, torch.as_tensor(lr, device=device), p["conv_out"]["kernel"],
            p["conv_out"]["bias"], *_tail_operands(p, 4, "train"))


def _diff(a, b):
    d = (a.view(torch.uint8).long() - b.view(torch.uint8).long()).abs()
    return int(d.max()), float((d != 0).double().mean())


def _frames(seed, b, h, w, c, device="cpu"):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        rng.integers(0, 256, (b, h, w, c), dtype=np.uint8)).to(device)


def test_cpu_tensors_take_the_plain_versions_and_launch_nothing():
    args = _tail_args(8, 12, 4, seed=0)
    a0, b0 = pt.packed_tail_fused.launches, ilv.interleave_planar_u32.launches
    c0, d0 = mxu.resize_mxu.launches, phase.resize_phase.launches
    img = _frames(1, 2, 9, 7, 3)
    cache = {}
    got = mxu.resize_mxu(img, 2.5, "bicubic", weight_cache=cache)
    ops = next(iter(cache.values()))
    assert torch.equal(got, mxu.resize_mxu_reference(img, *ops[:4]))
    cache = {}
    got = phase.resize_phase(img, 3, "lanczos", weight_cache=cache)
    wrow, wcol, taps, left = next(iter(cache.values()))
    assert torch.equal(got, phase.resize_phase_reference(img, wrow, wcol, 3,
                                                         taps, left))
    assert (mxu.resize_mxu.launches, phase.resize_phase.launches) == (c0, d0)
    planar = pt.packed_tail_fused(*args, layout="planar")
    ref = pt.packed_tail_fused_reference(args[0][None], args[1][None],
                                         *args[2:])[0]
    assert torch.equal(planar.view(torch.int32), ref.view(torch.int32))
    words = ilv.interleave_planar_u32(planar)
    assert torch.equal(words.view(torch.int32),
                       ilv.interleave_planar_u32_reference(planar)
                       .contiguous().view(torch.int32))
    assert (pt.packed_tail_fused.launches,
            ilv.interleave_planar_u32.launches) == (a0, b0)


def test_importing_the_port_builds_nothing():
    """Importing every kernel module neither runs nvcc nor loads a
    library: the build happens at the first launch on a card."""
    code = ("from bicubic_interpolation_model_tpu_torch.ops import "
            "packed_tail, interleave, mxu, phase, resize\n"
            "from bicubic_interpolation_model_tpu_torch.runtime import build\n"
            "assert build._lib is None\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_kernel_sources_are_listed():
    from bicubic_interpolation_model_tpu_torch.runtime import build
    names = [p.name for p in build.sources()]
    assert names == ["interleave.cu", "packed_tail.cu", "resize_mxu.cu",
                     "resize_phase.cu"]
    for name in names:
        text = (build.CSRC / name).read_text()
        assert "Replaces:" in text and "extern \"C\"" in text
    entry_points = " ".join((build.CSRC / n).read_text() for n in names)
    for symbol in build._SIGNATURES:
        assert f"int {symbol}(" in entry_points
    assert len(build._SIGNATURES) == 4


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,c", GEOMETRIES)
def test_kernel_a_matches_plain_on_card(cuda, h, w, c):
    args = _tail_args(h, w, c, seed=h + w, device=cuda)
    before = pt.packed_tail_fused.launches
    got = pt.packed_tail_fused(*args, layout="planar")
    assert pt.packed_tail_fused.launches == before + 1
    ref = pt.packed_tail_fused_reference(args[0][None], args[1][None],
                                         *args[2:])[0]
    mx, share = _diff(got, ref)
    assert mx <= 1 and share < 1e-3
    assert float(got.view(torch.uint8).float().std()) > 0
    bf = (args[0].to(torch.bfloat16),) + args[1:]
    gb = pt.packed_tail_fused(*bf, layout="planar")
    rb = pt.packed_tail_fused_reference(bf[0][None], bf[1][None], *bf[2:])[0]
    assert _diff(gb, rb)[0] <= 2


@pytest.mark.cuda
def test_kernel_a_opaque_alpha_and_batch_on_card(cuda):
    args = _tail_args(21, 45, 4, seed=11, device=cuda, opaque=True)
    got = pt.packed_tail_fused(*args, layout="planar", opaque_alpha=True)
    ref = pt.packed_tail_fused_reference(args[0][None], args[1][None],
                                         *args[2:], opaque_alpha=True)[0]
    assert _diff(got, ref)[0] <= 1
    two = pt.packed_tail_fused(torch.stack([args[0], args[0].flip(0)]),
                               torch.stack([args[1], args[1].flip(0)]),
                               *args[2:], layout="planar")
    assert torch.equal(two[0].view(torch.int32),
                       pt.packed_tail_fused(*args, layout="planar")
                       .view(torch.int32))
    one = pt.packed_tail_fused(args[0].flip(0).contiguous(),
                               args[1].flip(0).contiguous(), *args[2:],
                               layout="planar")
    assert torch.equal(two[1].view(torch.int32), one.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 1392, 510), (3, 37, 53), (1, 5, 7)])
def test_kernel_b_matches_plain_on_card(cuda, shape):
    rng = np.random.default_rng(0)
    planar = torch.from_numpy(
        rng.integers(0, 2 ** 32, shape, dtype=np.uint32)).to(cuda)
    before = ilv.interleave_planar_u32.launches
    got = ilv.interleave_planar_u32(planar)
    assert ilv.interleave_planar_u32.launches == before + 1
    ref = ilv.interleave_planar_u32_reference(planar).contiguous()
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))


@pytest.mark.cuda
def test_kernels_refuse_non_contiguous_input(cuda):
    planar = torch.zeros((4, 8, 16), dtype=torch.uint32, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        ilv.interleave_planar_u32(planar[:, :, ::2])


def _diff_u8(a, b):
    d = (a.long() - b.long()).abs()
    return int(d.max()), float((d != 0).double().mean())


METHODS = ["nearest", "bilinear", "bicubic", "lanczos"]


@pytest.mark.cuda
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("scale,h,w", [
    (4, 23, 37), (2, 23, 37), (3, 13, 9), (1.5, 40, 64), (2.5, 40, 64),
    (1.25, 40, 64), (1, 13, 9)])
def test_kernel_c_matches_plain_on_card(cuda, method, scale, h, w):
    for c in (1, 2, 3, 4):
        img = _frames(h + c, 2, h, w, c, cuda)
        cache = {}
        before = mxu.resize_mxu.launches
        got = mxu.resize_mxu(img, scale, method, weight_cache=cache)
        assert mxu.resize_mxu.launches == before + 1
        ops = next(iter(cache.values()))
        mx, share = _diff_u8(got, mxu.resize_mxu_reference(img, *ops[:4]))
        assert mx <= 1 and share < 1e-3
        assert mx == 0 or method != "nearest"
        assert _diff_u8(got, mxu.resize_mxu_reference(
            img, *ops[:4], dtype=torch.float64))[0] <= 1
        assert float(got.float().std()) > 0
        assert torch.equal(got[1], mxu.resize_mxu(img[1], scale, method))
        gf = mxu.resize_mxu(img.float(), scale, method)
        rf = mxu.resize_mxu_reference(img.float(), *ops[:4])
        assert gf.dtype == torch.float32
        assert float((gf - rf).abs().max()) < 1e-3


@pytest.mark.cuda
def test_kernel_c_flat_layout_and_full_frame_on_card(cuda):
    img = _frames(0, 1, 1080, 1920, 4, cuda)
    cache = {}
    flat = mxu.resize_mxu(img, 4, "bicubic", layout="flat",
                          weight_cache=cache)
    assert flat.shape == (1, 4320, 7680 * 4)
    ops = next(iter(cache.values()))
    ref = mxu.resize_mxu_reference(img, *ops[:4], dtype=torch.float64)
    view = mxu.flat_to_hwc_np(flat[0, :64].cpu().numpy(), 64, 7680, 4)
    np.testing.assert_array_equal(
        view, mxu.resize_mxu(img, 4, "bicubic")[0, :64].cpu().numpy())
    mx, share = _diff_u8(flat.reshape(ref.shape), ref)
    assert mx <= 1 and share < 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("s", [1, 2, 3, 4])
def test_kernel_d_matches_plain_on_card(cuda, method, s):
    for h, w, c in [(23, 37, 4), (40, 64, 3), (13, 9, 1), (7, 5, 2)]:
        img = _frames(h + s, 2, h, w, c, cuda)
        cache = {}
        before = phase.resize_phase.launches
        got = phase.resize_phase(img, s, method, weight_cache=cache)
        assert phase.resize_phase.launches == before + 1
        wrow, wcol, taps, left = next(iter(cache.values()))
        ref = phase.resize_phase_reference(img, wrow, wcol, s, taps, left)
        mx, share = _diff_u8(got, ref)
        assert mx <= 1 and share < 1e-3
        assert mx == 0 or method != "nearest"
        assert _diff_u8(got, phase.resize_phase_reference(
            img, wrow, wcol, s, taps, left, dtype=torch.float64))[0] <= 1
        planar = phase.resize_phase(img, s, method, layout="planar")
        assert planar.shape == (2, s, h * s, w * c)
        assert torch.equal(phase.interleave_planar(planar, h, w, s, c), got)
        assert torch.equal(got[1], phase.resize_phase(img[1], s, method))
        assert _diff_u8(got, mxu.resize_mxu(img, s, method))[0] <= 1
        gf = phase.resize_phase(img.float(), s, method)
        rf = phase.resize_phase_reference(img.float(), wrow, wcol, s, taps,
                                          left)
        assert float((gf - rf).abs().max()) < 1e-3


@pytest.mark.cuda
def test_kernel_d_lanczos_window_and_full_frame_on_card(cuda):
    img = _frames(3, 1, 20, 16, 4, cuda)
    a2 = phase.resize_phase(img, 4, "lanczos", lanczos_a=2)
    wrow, wcol, taps, left = phase._weights("lanczos", 20, 16, 4, -0.5, 2,
                                            cuda, None)
    assert taps == 4 and _diff_u8(a2, phase.resize_phase_reference(
        img, wrow, wcol, 4, taps, left))[0] <= 1
    big = _frames(4, 1, 1080, 1920, 4, cuda)
    got = phase.resize_phase(big, 4, "bicubic")
    mx, share = _diff_u8(got, mxu.resize_mxu(big, 4, "bicubic"))
    assert got.shape == (1, 4320, 7680, 4) and mx <= 1 and share < 1e-3


@pytest.mark.cuda
def test_resize_and_upscaler_route_to_the_kernels_on_card(cuda):
    from bicubic_interpolation_model_tpu_torch.ops.resize import resize
    from bicubic_interpolation_model_tpu_torch.serving import Upscaler
    img = _frames(5, 1, 24, 20, 4)[0].numpy()
    c0, d0 = mxu.resize_mxu.launches, phase.resize_phase.launches
    out = resize(img, 4)
    assert out.is_cuda and mxu.resize_mxu.launches == c0 + 1
    assert _diff_u8(out, resize(img, 4, impl="gather"))[0] <= 1
    # a 1-channel frame at 17/16 is outside the JAX tiler's set and inside
    # kernel C's: it takes the kernel, not the plain graph
    gray = resize(img[..., 0], 17 / 16)
    assert not mxu.mxu_supported(17 / 16, 1)
    assert gray.shape == (26, 21) and mxu.resize_mxu.launches == c0 + 2
    assert _diff_u8(gray, resize(img[..., 0], 17 / 16,
                                 impl="gather"))[0] <= 1
    # numpy frames handed to the wrappers themselves go to the card
    assert mxu.resize_mxu(img, 2).is_cuda and phase.resize_phase(img, 2).is_cuda
    assert (mxu.resize_mxu.launches, phase.resize_phase.launches) == (
        c0 + 3, d0 + 1)
    c0, d0 = c0 + 3, d0 + 1
    # what no kernel takes goes to the plain graph: 5 channels, a scale
    # with no small rational form
    five = np.concatenate([img, img[..., :1]], axis=-1)
    assert resize(five, 4).shape == (96, 80, 5)
    assert resize(img, 2 ** 0.5).shape == (34, 28, 4)
    wide = Upscaler(scale=4)
    b5 = wide.batch(np.stack([five, five]))
    assert b5.shape == (2, 96, 80, 5)
    np.testing.assert_array_equal(b5[0], wide(five))
    np.testing.assert_array_equal(list(wide.stream([five, five]))[1], b5[1])
    assert (mxu.resize_mxu.launches, phase.resize_phase.launches) == (c0, d0)
    # float batches take the same kernel as float frames
    fb = wide.batch(np.stack([img, img]).astype(np.float32), fetch=False)
    assert fb.dtype == torch.float32 and mxu.resize_mxu.launches == c0 + 1
    assert torch.equal(fb[0], wide(img.astype(np.float32), fetch=False))
    assert Upscaler(scale=4, bucket=16)(img).shape == (96, 80, 4)
    c0 = mxu.resize_mxu.launches
    assert resize(img, 3, impl="pallas_phase").shape == (72, 60, 4)
    assert phase.resize_phase.launches == d0 + 1
    up = Upscaler(scale=2.5)
    host = up(img)
    assert isinstance(host, np.ndarray) and host.shape == (60, 50, 4)
    assert mxu.resize_mxu.launches == c0 + 1
    assert _diff_u8(torch.from_numpy(host).to(cuda),
                    resize(img, 2.5, impl="gather"))[0] <= 1
    outs = list(Upscaler(scale=4, impl="pallas_phase").stream([img, img]))
    assert phase.resize_phase.launches == d0 + 2   # one grouped launch
    assert _diff_u8(torch.from_numpy(outs[1]).to(cuda), out)[0] <= 1
