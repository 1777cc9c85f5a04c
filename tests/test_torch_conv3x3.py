"""The 3x3 conv kernel of the port (``csrc/conv3x3_tc.cu``, wrapper
``ops/conv3x3.conv3x3_tc``): the wrapper's contract and plain version on
the CPU, the packed weights' layout against the kernel's fragment map, an
emulation of its 3xTF32 arithmetic, and the kernel on the card against
float64 at every shape the published ESRGAN's path gives it.

This file imports nothing of JAX, so it also runs on a machine with a card
and no JAX: ``python -m pytest --noconftest -m cuda
tests/test_torch_conv3x3.py``. Tests marked ``cuda`` skip without a card (a
CUDA kernel has no CPU mode).

Tolerances:

- the plain version against ``F.conv2d`` + bias + the epilogue written
  out: the same ops, bit-equal, except the scaled residual written as a
  multiply and an add (``torch.add(..., alpha=)`` may fuse them): 1e-6.
- the CPU emulation of the kernel's 3xTF32 products (round-to-nearest
  split, a fresh sum a k8 step added in f32) against float64: within 2x
  the error of a plain f32 conv on the same inputs, scaled by the sum of
  the products' magnitudes; one TF32 pass (hi * hi only) is off by more
  than 100x that.
- on the card, the kernel's largest error per output against float64,
  scaled by the output's sum of magnitudes (products, bias, residual and
  outer terms), at most ``CARD_MULTIPLE`` times cuDNN f32's (TF32 off) on
  the same inputs; both are printed. The epilogue's writes leave every
  other element of the destination buffer as it was.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from bicubic_interpolation_model_tpu_torch.ops import conv3x3 as c3
from bicubic_interpolation_model_tpu_torch.runtime.device import (
    conv_precision)

#: the kernel's error against float64 over cuDNN f32's, at most
CARD_MULTIPLE = 4.0


def _interior(t):
    return t[..., 1:-1, 1:-1]


def _case(cin, cout, h, w, pad, epilogue, seed, device="cpu"):
    """Inputs of one conv as the model hands them over, drawn by numpy from
    ``seed``: with ``pad`` 0 the input is the channel prefix of a
    zero-bordered buffer and a leaky conv writes the interior of the
    buffer's next ``cout`` channels (a dense block's conv), a residual conv
    reads its residual from the buffer's first ``cout`` channels and writes
    the interior of a second buffer (conv_4); with ``pad`` 1 the frames
    are plain tensors. ``epilogue``: "plain", "leaky", "residual" or
    "outer". Returns (x, kernel, bias, kwargs, dst buffer or None)."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    feat = t(np.where(rng.random((cin, h, w)) < 0.3, -0.2, 1.0)
             * rng.normal(0, 1, (cin, h, w)))
    kernel = t(rng.normal(0, np.sqrt(2 / (9 * cin)), (3, 3, cin, cout)))
    bias = t(rng.normal(0, 0.1, cout))
    kw = {"padding": pad}
    if epilogue == "leaky":
        kw["leaky"] = True
    dst = None
    if pad == 0:
        buf = torch.zeros((1, cin + cout, h + 2, w + 2), device=device)
        _interior(buf[0, :cin]).copy_(feat)
        x = buf[:, :cin]
        if epilogue == "leaky":
            dst, kw["out"] = buf, _interior(buf[:, cin:])
        elif epilogue in ("residual", "outer"):
            kw["residual"] = _interior(buf[:, :cout])
            dst = torch.full((1, cout + 8, h + 2, w + 2), 7.0,
                             device=device)
            kw["out"] = _interior(dst[:, 8:])
    else:
        x = feat[None]
        if epilogue in ("residual", "outer"):
            kw["residual"] = t(rng.normal(0, 1, (1, cout, h, w)))
    if epilogue in ("residual", "outer"):
        kw["alpha"] = 0.2
    if epilogue == "outer":
        kw["outer"] = t(rng.normal(0, 1, (1, cout, h, w)))
    return x, kernel, bias, kw, dst


def _expected(x, kernel, bias, kw):
    """F.conv2d with its bias, then the epilogue written out."""
    y = F.conv2d(x, kernel.permute(3, 2, 0, 1), bias, padding=kw["padding"])
    if kw.get("leaky"):
        y = torch.where(y > 0, y, y * 0.2)
    if "residual" in kw:
        y = kw["residual"] + kw["alpha"] * y
    if "outer" in kw:
        y = kw["outer"] + 0.2 * y
    return y


EPILOGUES = ["plain", "leaky", "residual", "outer"]


# -- on the CPU --------------------------------------------------------------

@pytest.mark.parametrize("pad", [0, 1])
@pytest.mark.parametrize("epilogue", EPILOGUES)
def test_plain_version_is_conv2d_bias_and_epilogue(epilogue, pad):
    x, kernel, bias, kw, dst = _case(16, 8, 9, 13, pad, epilogue, seed=3)
    before = None if dst is None else dst.clone()
    want = _expected(x, kernel, bias, kw)
    launches = c3.conv3x3_tc.launches
    got = c3.conv3x3_tc(x, kernel, bias, **kw)
    assert c3.conv3x3_tc.launches == launches
    assert got.shape == (1, 8, 9, 13)
    if "out" in kw:
        assert got.data_ptr() == kw["out"].data_ptr()
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    if dst is not None:
        # nothing but the destination's interior channels changed
        changed = (dst != before)
        changed[..., -8:, 1:-1, 1:-1] = False
        assert not bool(changed.any())


def test_plain_version_runs_in_the_frame_dtype():
    x, kernel, bias, kw, _ = _case(8, 16, 5, 6, 1, "outer", seed=4)
    kw64 = {k: (v.double() if torch.is_tensor(v) else v)
            for k, v in kw.items()}
    got = c3.conv3x3_tc(x.double(), kernel.double(), bias.double(), **kw64)
    assert got.dtype == torch.float64
    torch.testing.assert_close(
        got, _expected(x.double(), kernel.double(), bias.double(), kw64))


def _bad(case):
    x = torch.zeros((1, 16, 6, 7))
    k = torch.zeros((3, 3, 16, 32))
    b = torch.zeros(32)
    kw = {}
    if case == "c_in":
        x, k = torch.zeros((1, 12, 6, 7)), torch.zeros((3, 3, 12, 32))
    elif case == "c_out":
        k, b = torch.zeros((3, 3, 16, 65)), torch.zeros(65)
    elif case == "kernel_size":
        k = torch.zeros((5, 5, 16, 32))
    elif case == "kernel_c_in":
        k = torch.zeros((3, 3, 24, 32))
    elif case == "dtype":
        x = x.to(torch.int32)
    elif case == "kernel_dtype":
        k = k.double()
    elif case == "bias":
        b = torch.zeros(31)
    elif case == "bias_strided":
        b = torch.zeros(64)[::2]
    elif case == "batch":
        x = torch.zeros((2, 16, 6, 7))
    elif case == "last_dim_strided":
        x = torch.zeros((1, 16, 7, 6)).transpose(2, 3)
    elif case == "padding":
        kw["padding"] = 2
    elif case == "out_shape":
        kw["out"] = torch.zeros((1, 32, 6, 6))
    elif case == "out_strided":
        kw["out"] = torch.zeros((1, 32, 7, 6)).transpose(2, 3)
    elif case == "residual_dtype":
        kw["residual"] = torch.zeros((1, 32, 6, 7), dtype=torch.float64)
    elif case == "outer_alone":
        kw["outer"] = torch.zeros((1, 32, 6, 7))
    elif case == "empty":
        x, kw["padding"] = torch.zeros((1, 16, 2, 7)), 0
    return x, k, b, kw


@pytest.mark.parametrize("case", [
    "c_in", "c_out", "kernel_size", "kernel_c_in", "dtype", "kernel_dtype",
    "bias", "bias_strided", "batch", "last_dim_strided", "padding", "out_shape",
    "out_strided", "residual_dtype", "outer_alone", "empty"])
def test_wrapper_raises_on_what_the_kernel_does_not_take(case):
    x, k, b, kw = _bad(case)
    with pytest.raises(ValueError, match="conv3x3_tc"):
        c3.conv3x3_tc(x, k, b, **kw)


def test_serves_float_frames_on_the_cpu_and_float32_on_the_card():
    assert c3.serves(torch.zeros(1)) and c3.serves(torch.zeros(1).double())
    assert not c3.serves(torch.zeros(1, dtype=torch.int32))
    assert not c3.serves(torch.zeros(1, device="meta"))


@pytest.mark.parametrize("cin,cout", [(16, 32), (24, 8), (8, 64), (32, 40)])
def test_packed_weights_are_the_kernels_split_core_matrices(cin, cout):
    """Per k8 step (input channels 8 c8 .., one tap) and part (hi, lo), B
    as wgmma reads it without swizzle: element (k, n) at float 64 (n // 8)
    + 32 (k // 4) + 4 (n % 8) + k % 4, the weight of output channel n (zero
    past C_out) at input channel 8 c8 + k; hi rounded to the nearest TF32
    value and lo the rest rounded the same way."""
    k = torch.randn((3, 3, cin, cout), generator=torch.Generator()
                    .manual_seed(cin + cout))
    n = 32 if cout <= 32 else 64
    p = c3.pack(k).reshape(cin // 8, 9, 2, 8 * n)
    kp = torch.zeros((3, 3, cin, n))
    kp[..., :cout] = k
    hi = torch.from_numpy(_tf32_rn(kp.numpy()))
    lo = torch.from_numpy(_tf32_rn((kp - hi).numpy()))
    assert torch.equal(c3.tf32_rn(kp), hi)
    assert float((hi + lo - kp).abs().max()) <= 2.0 ** -21 * float(
        kp.abs().max())
    kk, nn = np.meshgrid(np.arange(8), np.arange(n), indexing="ij")
    at = torch.from_numpy(64 * (nn // 8) + 32 * (kk // 4) + 4 * (nn % 8)
                          + kk % 4)
    for c8 in range(cin // 8):
        for tap in range(9):
            for part, want in enumerate((hi, lo)):
                w = want[tap // 3, tap % 3, 8 * c8:8 * c8 + 8]     # [k, n]
                assert torch.equal(p[c8, tap, part][at], w)


def test_packed_weights_are_kept_until_the_kernel_changes():
    k = torch.randn((3, 3, 8, 32))
    first = c3.packed_weights(k)
    assert c3.packed_weights(k) is first
    with torch.no_grad():
        k.mul_(2)
    again = c3.packed_weights(k)
    assert again is not first and torch.equal(again, 2 * first)


def _tf32_rn(a):
    """f32 values rounded to the nearest TF32 value as the kernel rounds
    them (add half an ulp of TF32 to the bits, clear the low 13)."""
    bits = np.asarray(a, np.float32).view(np.uint32).astype(np.uint64)
    return ((bits + 0x1000) & 0xFFFFE000).astype(np.uint32).view(np.float32)


def _split(a):
    hi = _tf32_rn(a)
    return hi, _tf32_rn(np.asarray(a, np.float32) - hi)


def _emulate(x, k, passes):
    """The kernel's sum for a padded [C, H + 2, W + 2] frame and an HWIO
    kernel: per k8 step (8 channels, one tap) the products ``passes`` of
    the split operands summed in float64 (the tensor cores' k8 sum, here
    without its truncation), then added to an f32 running sum."""
    cin, hp, wp = x.shape
    h, w = hp - 2, wp - 2
    xh, xl = _split(x)
    kh, kl = _split(k)
    terms = {"hh": (xh, kh), "lh": (xl, kh), "hl": (xh, kl)}
    acc = np.zeros((k.shape[3], h, w), np.float32)
    for c8 in range(0, cin, 8):
        for ky in range(3):
            for kx in range(3):
                step = np.zeros_like(acc, dtype=np.float64)
                for name in passes:
                    a, b = terms[name]
                    win = a[c8:c8 + 8, ky:ky + h, kx:kx + w].astype(
                        np.float64)
                    step += np.einsum("chw,co->ohw", win,
                                      b[ky, kx, c8:c8 + 8].astype(np.float64))
                acc = (acc + step.astype(np.float32)).astype(np.float32)
    return acc


def test_3xtf32_emulation_is_as_accurate_as_an_f32_conv():
    rng = np.random.default_rng(11)
    cin, cout, h, w = 64, 32, 12, 20
    x = np.zeros((cin, h + 2, w + 2), np.float32)
    x[:, 1:-1, 1:-1] = rng.normal(0, 1, (cin, h, w))
    k = rng.normal(0, np.sqrt(2 / (9 * cin)), (3, 3, cin, cout)).astype(
        np.float32)
    xt, kt = torch.from_numpy(x)[None], torch.from_numpy(k).permute(
        3, 2, 0, 1)
    exact = F.conv2d(xt.double(), kt.double())[0].numpy()
    mag = F.conv2d(xt.double().abs(), kt.double().abs())[0].numpy()
    f32 = F.conv2d(xt, kt)[0].numpy()
    err = lambda y: float((np.abs(y - exact) / mag).max())
    three = err(_emulate(x, k, ("lh", "hl", "hh")))
    one = err(_emulate(x, k, ("hh",)))
    print(f"scaled error: 3xTF32 {three:.3g}, f32 conv {err(f32):.3g}, "
          f"one TF32 pass {one:.3g}")
    assert three <= 2 * err(f32)
    assert one > 100 * err(f32)


# -- on the card -------------------------------------------------------------

LR, LR2, LR4 = (339, 510), (678, 1020), (1356, 2040)
RAGGED, RAGGED2, RAGGED4 = (37, 53), (74, 106), (148, 212)
CARD_CASES = (
    # every dense-block conv: leaky into the buffer's next channels
    [(cin, 32, hw, 0, "leaky") for cin in (64, 96, 128, 160)
     for hw in (LR, RAGGED)]
    # conv_4: the scaled residual, and with the RRDB's outer residual
    + [(192, 64, hw, 0, e) for hw in (LR, RAGGED)
       for e in ("residual", "outer")]
    # conv_body: its residual on the bordered trunk buffer
    + [(64, 64, LR, 0, "residual"), (64, 64, RAGGED, 0, "plain")]
    # the HR stage: plain frames, the kernel's own zero halo
    + [(64, 64, hw, 1, "leaky") for hw in (LR2, LR4, RAGGED2, RAGGED4)]
    + [(64, 64, RAGGED, 1, e) for e in ("plain", "residual", "outer")])


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (a CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _scaled_error(y, exact, mag):
    return float(((y.double() - exact).abs() / mag).max())


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout,hw,pad,epilogue", CARD_CASES)
def test_kernel_within_a_small_multiple_of_cudnn_f32_on_card(
        card, cin, cout, hw, pad, epilogue):
    x, kernel, bias, kw, dst = _case(cin, cout, *hw, pad, epilogue,
                                     seed=cin + cout + hw[0], device=card)
    before = None if dst is None else dst.clone()
    launches = c3.conv3x3_tc.launches
    got = c3.conv3x3_tc(x, kernel, bias, **kw)
    torch.cuda.synchronize()
    assert c3.conv3x3_tc.launches == launches + 1
    if dst is not None:
        changed = (dst != before)
        changed[..., -cout:, 1:-1, 1:-1] = False
        assert not bool(changed.any())
    d = lambda t: t.double() if torch.is_tensor(t) else t
    kw64 = {k: d(v) for k, v in kw.items() if k != "out"}
    exact = c3.conv3x3_tc_reference(d(x), d(kernel), d(bias), **kw64)
    absd = {k: (v.abs() if torch.is_tensor(v) else v)
            for k, v in kw64.items() if k != "leaky"}
    mag = c3.conv3x3_tc_reference(d(x).abs(), d(kernel).abs(),
                                  d(bias).abs(), **absd)
    with conv_precision(torch.float32):
        lib = c3.conv3x3_tc_reference(x, kernel, bias, **{
            k: v for k, v in kw.items() if k != "out"})
    ours, cudnn = _scaled_error(got, exact, mag), _scaled_error(
        lib, exact, mag)
    print(f"C_in {cin} -> {cout} at {hw[0]}x{hw[1]}, pad {pad}, {epilogue}: "
          f"scaled error kernel {ours:.3g}, cuDNN f32 {cudnn:.3g}")
    assert ours <= CARD_MULTIPLE * cudnn
