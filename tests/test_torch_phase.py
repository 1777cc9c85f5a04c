"""The port's ops/phase.py (the wrapper of CUDA kernel D and its plain
PyTorch version) on the CPU against the JAX package's
``resize_phase_pallas(interpret=True)`` and the float64 oracle.

Tolerances: ≤1 u8 LSB from ``resize_oracle`` with under 0.5% of bytes
differing; ≤1 LSB from the JAX kernel with under 0.5% differing (both f32:
only the order of the sums differs); ``nearest`` bit-equal; float outputs
within 1e-4 absolute on a 0-255 range."""

import functools

import numpy as np
import pytest
import torch

from bicubic_interpolation_model_tpu.core.oracle import resize_oracle
from bicubic_interpolation_model_tpu.ops import pallas_phase as jphase
from bicubic_interpolation_model_tpu_torch.ops import phase

METHODS = ["nearest", "bilinear", "bicubic", "lanczos"]

# numpy frames go to the card unless the caller asks for the CPU
resize_phase = functools.partial(phase.resize_phase, device="cpu")


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
    return int(d.max())


@pytest.mark.parametrize("method", METHODS)
def test_phase_parity(method):
    img = _image(0, 24, 18)
    got = resize_phase(img, 4, method)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.uint8
    _parity(got.numpy(), resize_oracle(img, 4.0, method))
    ref = np.asarray(jphase.resize_phase_pallas(img, 4, method, step=8,
                                                interpret=True))
    mx = _parity(got.numpy(), ref)
    if method == "nearest":
        assert mx == 0


@pytest.mark.parametrize("scale", [1, 2, 3])
def test_phase_scales(scale):
    img = _image(1, 22, 20)
    got = resize_phase(img, scale, "bicubic").numpy()
    _parity(got, resize_oracle(img, float(scale), "bicubic"))
    _parity(got, np.asarray(jphase.resize_phase_pallas(
        img, scale, "bicubic", step=8, interpret=True)))


def test_phase_rgb_and_small():
    img = _image(2, 7, 5, c=3)
    got = resize_phase(img, 4, "bicubic").numpy()
    _parity(got, resize_oracle(img, 4.0, "bicubic"))
    _parity(got, np.asarray(jphase.resize_phase_pallas(
        img, 4, "bicubic", step=8, interpret=True)))
    tiny = _image(3, 1, 2, c=1)
    for method in METHODS:
        _parity(resize_phase(tiny, 3, method).numpy(),
                resize_oracle(tiny, 3.0, method))
    gray = _image(4, 6, 7)[..., 0].copy()
    assert resize_phase(gray, 2, "bilinear").shape == (12, 14)


def test_phase_float():
    img = _image(5, 12, 10).astype(np.float32)
    out = resize_phase(img, 2, "bicubic")
    assert out.dtype == torch.float32
    ref = np.asarray(jphase.resize_phase_pallas(img, 2, "bicubic", step=8,
                                                interpret=True))
    assert np.abs(out.numpy() - ref).max() < 1e-4
    want = resize_oracle(img.astype(np.uint8), 2.0, "bicubic")
    _parity(np.clip(np.floor(out.numpy() + 0.5), 0, 255), want)


def test_phase_lanczos_window_param():
    img = _image(6, 20, 16)
    got = resize_phase(img, 4, "lanczos", lanczos_a=2).numpy()
    _parity(got, resize_oracle(img, 4.0, "lanczos", a=2))
    _parity(got, np.asarray(jphase.resize_phase_pallas(
        img, 4, "lanczos", lanczos_a=2, step=8, interpret=True)))
    assert (got != resize_phase(img, 4, "lanczos").numpy()).any()


def test_planar_layout_matches_hwc():
    imgs = np.stack([_image(7 + i, 19, 21) for i in range(2)])
    hwc = resize_phase(imgs, 4, "bicubic")
    planar = resize_phase(imgs, 4, "bicubic", layout="planar")
    assert planar.shape == (2, 4, 76, 84)      # [B, S, H*S, W*C]
    assert torch.equal(phase.interleave_planar(planar, 19, 21, 4, 4), hwc)
    np.testing.assert_array_equal(
        phase.interleave_planar(planar.numpy(), 19, 21, 4, 4), hwc.numpy())
    # the JAX form pads its planar extents to the tile grid; the valid
    # region holds the same image and the helper slices either
    jplanar = np.asarray(jphase.resize_phase_pallas(
        imgs, 4, "bicubic", step=8, wstep=16, layout="planar",
        interpret=True))
    assert jplanar.shape[2] >= 76 and jplanar.shape[3] >= 84
    _parity(phase.interleave_planar(jplanar, 19, 21, 4, 4), hwc.numpy())
    for i in range(2):
        assert torch.equal(hwc[i], resize_phase(imgs[i], 4, "bicubic"))


def test_planar_rejects_unbatched_and_bad_args():
    img = _image(9, 8, 8)
    with pytest.raises(ValueError, match="BHWC"):
        resize_phase(img, 2, "bicubic", layout="planar")
    with pytest.raises(ValueError, match="unknown layout"):
        resize_phase(img, 2, "bicubic", layout="flat")
    with pytest.raises(ValueError, match="integer upscale"):
        resize_phase(img, 2.5, "bicubic")
    with pytest.raises(ValueError, match="integer upscale"):
        resize_phase(img, 0, "bicubic")
    with pytest.raises(ValueError, match="channels"):
        resize_phase(np.zeros((4, 4, 5), np.uint8), 2, "bicubic")
    with pytest.raises(ValueError, match="unknown method"):
        resize_phase(img, 2, "adaptive")


@pytest.mark.parametrize("method", METHODS)
def test_plan_arrays_equal_the_reference(method):
    """The slot-scattered weights are the JAX package's, value for value
    (its column weights repeat each pixel's C times for the lane axis)."""
    h, w, c, s = 16, 24, 4, 4
    wrow, wcol, taps, left = phase._phase_plan_arrays(method, h, w, s,
                                                      -0.5, 3)
    jrow, jcol, jtaps, jleft = jphase._phase_plan_arrays(
        method, h, w, c, s, -0.5, 3, 8, 24, 2, 1)
    assert (taps, left) == (jtaps, jleft)
    np.testing.assert_array_equal(wrow, jrow)
    np.testing.assert_array_equal(wcol, jcol[:, ::c])
    np.testing.assert_array_equal(phase._interleave_wrow(wrow, s, taps),
                                  jphase._interleave_wrow(jrow, s, taps))
    for m in METHODS:
        for sc in (1, 2, 4):
            assert phase._n_slots(m, sc, 3) == jphase._n_slots(m, sc, 3)


def test_weight_cache_holds_one_entry_per_size():
    cache = {}
    for h, w in [(13, 11), (16, 16), (17, 16), (5, 31), (13, 11)]:
        img = _image(10 + h, h, w)
        got = resize_phase(img, 4, "bicubic", weight_cache=cache)
        assert torch.equal(got, resize_phase(img, 4, "bicubic"))
    assert len(cache) == 4
    wrow, wcol, taps, left = next(iter(cache.values()))[:4]
    assert wrow.shape == (13 * 4, 4) and wcol.shape == (4 * 4, 11)


def test_numpy_goes_to_the_card_and_tensors_run_where_they_lie():
    img = _image(20, 8, 8)
    t = torch.from_numpy(img)
    assert phase.resize_phase(t, 2, "bicubic").device.type == "cpu"
    assert torch.equal(phase.resize_phase(t, 2, "bicubic"),
                       resize_phase(img, 2, "bicubic"))
    if torch.cuda.is_available():
        assert phase.resize_phase(img, 2, "bicubic").is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            phase.resize_phase(img, 2, "bicubic")


@pytest.mark.parametrize("method,lanczos_a", [
    ("nearest", 3), ("bilinear", 3), ("bicubic", 3), ("lanczos", 3),
    ("lanczos", 2)])
@pytest.mark.parametrize("scale", [1, 3, 4, 6])
def test_kernel_weights_are_the_plan_arrays_restaged(method, lanczos_a,
                                                     scale):
    """The kernel's weights hold every slot weight of
    ``_phase_plan_arrays`` once, at the place a thread reads it (rows
    [r, phase group, t, phase], columns per 32-column tile [group, m, x,
    phase]), and zeros in the padding past the image and past phase S."""
    h, w = 13, 37
    wrow, wcol, taps, _ = phase._phase_plan_arrays(method, h, w, scale, -0.5,
                                                   lanczos_a)
    rows, cols = phase._kernel_weights(wrow, wcol, scale, taps)
    groups = -(-scale // 4)
    assert rows.dtype == cols.dtype == np.float32
    assert rows.shape == (16, groups, taps, 4)
    assert cols.shape == (2, groups, taps, 32, 4)
    r, q, t = np.meshgrid(np.arange(h), np.arange(scale), np.arange(taps),
                          indexing="ij")
    np.testing.assert_array_equal(rows[r, q // 4, t, q % 4],
                                  wrow[r, q * taps + t])
    x, p, m = np.meshgrid(np.arange(w), np.arange(scale), np.arange(taps),
                          indexing="ij")
    np.testing.assert_array_equal(cols[x // 32, p // 4, m, x % 32, p % 4],
                                  wcol[p * taps + m, x])
    # nothing else: the padding is zero
    assert np.count_nonzero(rows) == np.count_nonzero(wrow)
    assert np.count_nonzero(cols) == np.count_nonzero(wcol)


def test_kernel_tile_matches_the_source():
    """The host's restaging and the kernel agree on the tile and the phase
    group (csrc/resize_phase.cu)."""
    import pathlib
    src = (pathlib.Path(phase.__file__).resolve().parents[1] / "csrc"
           / "resize_phase.cu").read_text()
    for name, value in (("TILE_R", phase._TILE_R),
                        ("TILE_X", phase._TILE_X), ("PH", phase._PH)):
        assert f"constexpr int {name} = {value};" in src
