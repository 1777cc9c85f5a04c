"""The product precision of kernels A and G (csrc/tail_mma.cuh) against the
JAX package, emulated on the CPU.

The kernels compute the upsample and conv_out products of the packed tail
on the tensor cores: 3xTF32 on the f32 route (x = hi + lo, hi = x
truncated to TF32 and lo = x - hi truncated the same way; big = hi*hi, the
cross terms hi*lo + lo*hi summed apart and added to big once at the end)
and one bf16 pass with f32 accumulation on the bf16 route. The emulation
below applies exactly that to the port's plain tail (features from the port's conv_in/conv_res on the
``model/wp-1e-3-120`` checkpoint, a 40x64 RGBA frame made by numpy from a
seed: uniform noise, and a smooth gradient with mild noise).

Tolerances, the f32 contract of kernel A: ≤1 u8 LSB with a share of
differing bytes < 1e-3 against the JAX package's packed graph tail, ≤2 LSB
against its exact program. One TF32 pass exceeds that share, which is why
the kernels take three. The bf16 route is held to the port's plain bf16
tail (bf16 operands computed in f32: the same products) within 1 LSB."""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bicubic_interpolation_model_tpu.evaluation.model_analysis import (
    _load_model_any as jax_load_model_any)
from bicubic_interpolation_model_tpu.models import inference as J
from bicubic_interpolation_model_tpu_torch.models.zoo import load_model
from bicubic_interpolation_model_tpu_torch.models import inference as T
from bicubic_interpolation_model_tpu_torch.models.layers import conv_nhwc
from bicubic_interpolation_model_tpu_torch.ops.learned import (
    _apply_round, _edge_pad_chw)
from bicubic_interpolation_model_tpu_torch.ops.packed_tail import (
    packed_tail_fused_reference)
from bicubic_interpolation_model_tpu_torch.ops.planar import unpack_planar
from bicubic_interpolation_model_tpu_torch.runtime.device import (
    conv_precision)

CKPT = pathlib.Path(__file__).resolve().parents[1] / "model" / "wp-1e-3-120"
H, W = 40, 64


def tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 truncated to TF32 (sign, exponent and 10 mantissa bits), as the
    kernels split: the low 13 bits cleared."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def mm_3xtf32(a, b):
    """(big, small): hi*hi and the cross terms hi*lo + lo*hi, apart."""
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32(a - ah), tf32(b - bh)
    return ah @ bh, al @ bh + ah @ bl


def mm_tf32(a, b):
    big = tf32(a) @ tf32(b)
    return big, torch.zeros_like(big)


def mm_bf16(a, b):
    big = bf16(a) @ bf16(b)
    return big, torch.zeros_like(big)


def emulated_tail(y, lr_f32, kout, bout, kup, ubias, offs, att_w, att_b, mm,
                  rq=lambda t: t):
    """The fused tail of kernel A with its products taken by ``mm`` and its
    sums in the kernel's order: the upsample (+ ubias), the attention gate
    (``rq`` rounds where the bf16 route rounds), conv_out over the 16 gated
    up-lanes per tap with big and small accumulated over all taps apart,
    the offset lanes folded as valid x (offs @ kout[tap][16:32]) into big,
    tanh, the 16-tap apply. [B, h, w, 32] features → float [B, hS, wS, c]."""
    bsz, h, w, _ = y.shape
    c = lr_f32.shape[-1]
    big, small = mm(y.reshape(-1, 32), kup)
    up = (big + small + ubias.repeat(16)).reshape(bsz, h, w, 16, 16)
    att = rq(torch.sigmoid(rq(up) @ att_w + att_b))
    gated = torch.nn.functional.pad(rq(up * att[..., None]),
                                    (0, 0, 0, 0, 1, 1, 1, 1))
    valid = torch.nn.functional.pad(torch.ones(bsz, h, w), (1, 1, 1, 1))
    offc = torch.einsum("bi,yxio->yxbo", offs, kout[:, :, 16:])
    chw = _edge_pad_chw(lr_f32)
    cols = []
    for pp in range(4):
        planes = []
        for q in range(4):
            big = bout.expand(bsz, h, w, 16)
            small = torch.zeros(())
            for dy in (-1, 0, 1):
                p2, sy = (pp + dy) % 4, (pp + dy) // 4
                for dx in (-1, 0, 1):
                    q2, sx = (q + dx) % 4, (q + dx) // 4
                    win = (slice(None), slice(1 + sy, 1 + sy + h),
                           slice(1 + sx, 1 + sx + w))
                    big = big + valid[win][..., None] * offc[
                        dy + 1, dx + 1, p2 * 4 + q2]
                    b, s = mm(gated[win + (p2 * 4 + q2,)].reshape(-1, 16),
                              kout[dy + 1, dx + 1, :16])
                    big = big + b.reshape(bsz, h, w, 16)
                    small = small + s.reshape(bsz, h, w, 16)
            wts = torch.tanh(big + small)
            aw = sum(wts[:, None, :, :, i] * chw[:, :, i // 4:i // 4 + h,
                                                 i % 4:i % 4 + w]
                     for i in range(16))
            planes.append(aw)                              # [B, C, h, w]
        cols.append(torch.stack(planes, dim=-1))
    grid = torch.stack(cols, dim=3)                        # [B, C, h, S, w, S]
    return grid.permute(0, 2, 3, 4, 5, 1).reshape(bsz, h * 4, w * 4, c)


def frame(kind):
    rng = np.random.default_rng(55)
    if kind == "noise":
        return rng.integers(0, 256, (H, W, 4), dtype=np.uint8)
    yy, xx = np.mgrid[:H, :W]
    base = np.stack([3.1 * xx + 1.7 * yy, 2.3 * yy + 40, 255 - 3.7 * xx,
                     128 + 60 * np.sin(xx / 7.0)], axis=-1)
    return np.clip(base + rng.normal(0, 4, base.shape), 0, 255).astype(
        np.uint8)


@pytest.fixture(scope="module")
def models():
    return jax_load_model_any(str(CKPT)), load_model(CKPT, device="cpu")


@pytest.fixture(scope="module", params=["noise", "smooth"])
def case(request, models):
    """The frame, the JAX package's packed graph tail and exact program on
    it, and the port's features and tail operands (f32)."""
    (jmodel, jparams), (_, params) = models
    img = frame(request.param)
    graph = np.asarray(J._super_resolve_packed(jparams, jnp.asarray(img), 4,
                                               "train", tail="xla"))
    exact = np.asarray(J.super_resolve(jmodel, jparams, img,
                                       convention="train", exact=True))
    p = T.param_tree(params)
    lr = torch.as_tensor(img).float()[None]
    with conv_precision(torch.float32):
        y = torch.relu(conv_nhwc(lr / 255.0, **p["conv_in"]))
        y = y + conv_nhwc(y, **p["conv_res"])
    args = (y, lr, p["conv_out"]["kernel"], p["conv_out"]["bias"],
            *T.build_tail_operands(p, 4, "train"))
    return {"graph": graph, "exact": exact, "args": args}


def _u8(out):
    return _apply_round(out).to(torch.uint8)[0].numpy()


def _diff(a, b):
    d = np.abs(a.astype(np.int64) - b.astype(np.int64))
    return int(d.max()), float((d != 0).mean())


def test_tf32_split_truncates_and_keeps_21_bits():
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(0, 10, 10000).astype(np.float32))
    hi = tf32(x)
    assert torch.all((hi.view(torch.int32) & 0x1FFF) == 0)
    assert torch.all((x - hi).abs() < x.abs() * 2.0 ** -10)
    assert torch.all(hi.abs() <= x.abs()) and torch.all(hi * x >= 0)
    assert tf32(torch.tensor([1 + 2.0 ** -11, -(1 + 3 * 2.0 ** -11)])
                ).tolist() == [1.0, -(1 + 2.0 ** -10)]
    lo = tf32(x - hi)
    # hi + lo keeps 21 bits: far below what a u8 output can see
    assert torch.all((x - hi - lo).abs() < x.abs() * 2.0 ** -20)


def test_3xtf32_tail_matches_the_jax_graph_tail(case):
    got = _u8(emulated_tail(*case["args"], mm=mm_3xtf32))
    mx, share = _diff(got, case["graph"])
    assert mx <= 1 and share < 1e-3
    assert got.std() > 0


def test_3xtf32_tail_within_two_lsb_of_exact(case):
    got = _u8(emulated_tail(*case["args"], mm=mm_3xtf32))
    assert _diff(got, case["exact"])[0] <= 2


def test_one_tf32_pass_breaks_the_share(case):
    """One TF32 pass, the cheapest tensor-core route, misses the contract:
    the kernels need the three passes."""
    got = _u8(emulated_tail(*case["args"], mm=mm_tf32))
    assert _diff(got, case["graph"])[1] > 1e-3


def test_bf16_pass_matches_the_plain_bf16_tail(case):
    y, lr, kout, bout, kup, ubias, offs, att_w, att_b = case["args"]
    yb = y.to(torch.bfloat16)
    ref = packed_tail_fused_reference(yb, lr, kout, bout, kup, ubias, offs,
                                      att_w, att_b)
    got = _u8(emulated_tail(yb.float(), lr, bf16(kout), bout, bf16(kup),
                            ubias, bf16(offs), bf16(att_w), att_b,
                            mm=mm_bf16, rq=bf16))
    want = unpack_planar(ref, H, W, 4, 4)[0].numpy()
    mx, share = _diff(got, want)
    assert mx <= 1 and share < 1e-3
