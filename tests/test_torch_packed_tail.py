"""The port's fused packed tail and interleave (kernel A and kernel B
wrappers, bicubic_interpolation_model_tpu_torch/ops/{packed_tail,interleave,
planar}.py) against the JAX package's Pallas kernels run in interpret mode.

On the CPU the wrappers run their plain PyTorch versions. Tolerances: the
tail ≤1 u8 LSB with a share of differing bytes < 1e-3 (the same f32 ops
summed in another order) and a non-constant output; the interleave and the
planar unpack bit-equal. The CUDA kernels themselves are held against the
plain versions on the card in test_torch_kernels.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bicubic_interpolation_model_tpu.models.inference import (
    _merged_map_mats as jax_merged_map_mats)
from bicubic_interpolation_model_tpu.ops.pallas_adaptive import (
    unpack_planar as jax_unpack_planar)
from bicubic_interpolation_model_tpu.ops.pallas_interleave import (
    interleave_planar_u32 as jax_interleave_planar_u32)
from bicubic_interpolation_model_tpu.ops.pallas_packed_tail import (
    packed_tail_fused as jax_packed_tail_fused)
from bicubic_interpolation_model_tpu_torch.models.inference import (
    _merged_map_mats, build_tail_operands)
from bicubic_interpolation_model_tpu_torch.ops.interleave import (
    interleave_planar_u32, interleave_planar_u32_reference, rgba32_to_hwc_np)
from bicubic_interpolation_model_tpu_torch.ops.packed_tail import (
    packed_tail_fused, packed_tail_fused_reference, packed_tail_supported)
from bicubic_interpolation_model_tpu_torch.ops.planar import (
    _round_up, pack_rgba32, unpack_planar)

GEOMETRIES = [(24, 40, 4), (19, 37, 4), (13, 9, 3), (8, 128, 1)]


def _wp_tail_params(rng):
    n = lambda *s: rng.normal(0, 0.25, s).astype(np.float32)
    return {"upsample": {"kernel": n(4, 4, 16, 32), "bias": n(16)},
            "conv_att": {"kernel": n(1, 1, 16, 1), "bias": n(1)},
            "conv_off": {"kernel": n(1, 1, 2, 16), "bias": n(16)},
            "conv_out": {"kernel": n(3, 3, 32, 16) * 0.4, "bias": n(16)}}


def _case(h, w, c, seed, opaque=False):
    """Numpy inputs for both packages: features, pixels, tail params."""
    rng = np.random.default_rng(seed)
    p = _wp_tail_params(rng)
    y = rng.normal(0, 0.5, (h, w, 32)).astype(np.float32)
    lr = rng.integers(0, 256, (h, w, c)).astype(np.float32)
    if opaque:
        lr[..., 3] = 255.0
    return p, y, lr


def _torch_args(p, y, lr):
    tp = {k: {kk: torch.as_tensor(vv) for kk, vv in v.items()}
          for k, v in p.items()}
    return (torch.as_tensor(y), torch.as_tensor(lr),
            tp["conv_out"]["kernel"], tp["conv_out"]["bias"],
            *build_tail_operands(tp, 4, "train"))


def _jax_tail(p, y, lr, **kw):
    jp = {k: {kk: jnp.asarray(vv) for kk, vv in v.items()}
          for k, v in p.items()}
    mats = jax_merged_map_mats(jp, 4, "train")
    return np.asarray(jax_packed_tail_fused(
        jnp.asarray(y) if y.dtype == np.float32 else y, jnp.asarray(lr), jp["conv_out"]["kernel"],
        jp["conv_out"]["bias"], *mats, scale=4, **kw))


@pytest.mark.parametrize("h,w,c", GEOMETRIES)
def test_plain_fused_tail_matches_pallas(h, w, c):
    p, y, lr = _case(h, w, c, seed=h * 7919 + w)
    ref = _jax_tail(p, y, lr).astype(np.int64)
    got = packed_tail_fused(*_torch_args(p, y, lr)).numpy().astype(np.int64)
    assert got.shape == ref.shape == (h * 4, w * 4, c)
    d = np.abs(got - ref)
    assert d.max() <= 1 and (d != 0).mean() < 1e-3
    assert got.std() > 0


def test_plain_fused_tail_opaque_alpha_matches_pallas():
    p, y, lr = _case(21, 45, 4, seed=11, opaque=True)
    ref = _jax_tail(p, y, lr, opaque_alpha=True).astype(np.int64)
    got = packed_tail_fused(*_torch_args(p, y, lr),
                            opaque_alpha=True).numpy().astype(np.int64)
    d = np.abs(got - ref)
    assert d.max() <= 1 and (d != 0).mean() < 1e-3
    # alpha = rint(255 * sum(w)): not the 16-tap sum of a constant 255
    full = packed_tail_fused(*_torch_args(p, y, lr)).numpy().astype(np.int64)
    assert np.abs(got[..., :3] - full[..., :3]).max() == 0


def test_fused_tail_layouts():
    p, y, lr = _case(16, 24, 4, seed=9)
    args = _torch_args(p, y, lr)
    hwc = packed_tail_fused(*args)
    h32 = packed_tail_fused(*args, layout="hwc32")
    planar = packed_tail_fused(*args, layout="planar")
    assert hwc.shape == (64, 96, 4) and hwc.dtype == torch.uint8
    assert h32.shape == (64, 96) and h32.dtype == torch.uint32
    assert planar.shape == (4, 64, 24) and planar.dtype == torch.uint32
    assert np.array_equal(rgba32_to_hwc_np(h32.numpy(), 64, 96), hwc.numpy())
    assert torch.equal(unpack_planar(planar, 16, 24, 4, 4), hwc)
    batched = packed_tail_fused(args[0][None].expand(2, -1, -1, -1),
                                args[1][None].expand(2, -1, -1, -1),
                                *args[2:], layout="hwc32")
    assert batched.shape == (2, 64, 96)
    assert torch.equal(batched[1].view(torch.int32), h32.view(torch.int32))


def test_plain_fused_tail_bf16_matches_pallas():
    """bf16 features: the plain version rounds the merged-map stages where
    the Pallas kernel does (bf16 operands, f32 accumulation), so the two
    agree like the f32 forms: ≤1 u8 LSB, share < 1e-3. (The ≤3-LSB
    bf16-vs-f32 envelope is a property of trained weights and is tested on
    a checkpoint in test_torch_inference.py.)"""
    p, y, lr = _case(24, 40, 4, seed=21)
    ref = _jax_tail(p, jnp.asarray(y, jnp.bfloat16), lr).astype(np.int64)
    args = _torch_args(p, y, lr)
    got = packed_tail_fused(args[0].to(torch.bfloat16), *args[1:])
    d = np.abs(got.numpy().astype(np.int64) - ref)
    assert d.max() <= 1 and (d != 0).mean() < 1e-3


def test_fused_tail_rejects_what_the_kernel_does_not_take():
    p, y, lr = _case(8, 8, 4, seed=1)
    args = list(_torch_args(p, y, lr))
    with pytest.raises(ValueError, match="layout"):
        packed_tail_fused(*args, layout="chw")
    bad = list(args)
    bad[1] = torch.zeros(8, 8, 5)
    with pytest.raises(ValueError, match="c<=4"):
        packed_tail_fused(*bad)
    bad = list(args)
    bad[0] = args[0].double()
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        packed_tail_fused(*bad)
    bad = list(args)
    bad[8] = torch.zeros(16)
    with pytest.raises(ValueError, match="att_b"):
        packed_tail_fused(*bad)
    bad = list(args)
    bad[4] = torch.zeros(32, 512)
    with pytest.raises(ValueError, match="S\\*2F==128"):
        packed_tail_fused(*bad)
    bad = list(args)
    bad[0] = torch.zeros(8, 8, 16)
    with pytest.raises(ValueError, match="y: expected"):
        packed_tail_fused(*bad)
    bad = list(args)
    bad[1] = torch.zeros(8, 8, 3)
    with pytest.raises(ValueError, match="hwc32"):
        packed_tail_fused(*bad, layout="hwc32")


@pytest.mark.parametrize("convention", ["train", "inference"])
def test_flat_mats_match_jax(convention):
    """The flat merged-map matrices the plain version builds from the
    kernel's compact operands equal the JAX package's ``_merged_map_mats``
    (≤1e-6: the offset constant is one small matmul)."""
    p, _, _ = _case(4, 4, 4, seed=3)
    tp = {k: {kk: torch.as_tensor(vv) for kk, vv in v.items()}
          for k, v in p.items()}
    jp = {k: {kk: jnp.asarray(vv) for kk, vv in v.items()}
          for k, v in p.items()}
    got = _merged_map_mats(tp, 4, convention)
    ref = jax_merged_map_mats(jp, 4, convention)
    for g, r in zip(got, ref):
        assert tuple(g.shape) == r.shape
        assert np.abs(g.numpy() - np.asarray(r)).max() <= 1e-6


def test_packed_tail_supported():
    assert packed_tail_supported(4, 32, 4)
    assert packed_tail_supported(4, 32, 1)
    assert not packed_tail_supported(3, 32, 4)
    assert not packed_tail_supported(4, 48, 4)
    assert not packed_tail_supported(4, 32, 5)


@pytest.mark.parametrize("shape", [(4, 64, 24), (3, 37, 53), (2, 8, 128)])
def test_plain_interleave_matches_pallas(shape):
    rng = np.random.default_rng(sum(shape))
    planar = rng.integers(0, 2 ** 32, shape, dtype=np.uint32)
    ref = np.asarray(jax_interleave_planar_u32(jnp.asarray(planar)))
    got = interleave_planar_u32(torch.from_numpy(planar))
    assert got.dtype == torch.uint32
    assert np.array_equal(got.numpy(), ref)


def test_interleave_rejects_bad_input():
    with pytest.raises(ValueError):
        interleave_planar_u32(torch.zeros(4, 8, 8, dtype=torch.int32))
    with pytest.raises(ValueError):
        interleave_planar_u32(torch.zeros(17, 2, 2, dtype=torch.uint32))


@pytest.mark.parametrize("h,w,c", [(16, 24, 4), (5, 7, 3), (8, 9, 1)])
def test_unpack_planar_matches_jax(h, w, c):
    rng = np.random.default_rng(h + w + c)
    r_pad, x_pad = _round_up(h * 4, 8), _round_up(w, 128)
    planar = rng.integers(0, 2 ** 32, (4, r_pad, x_pad), dtype=np.uint32)
    ref = np.asarray(jax_unpack_planar(jnp.asarray(planar), h, w, 4, c))
    got = unpack_planar(torch.from_numpy(planar), h, w, 4, c).numpy()
    assert np.array_equal(got, ref)


def test_pack_rgba32_bytes():
    rng = np.random.default_rng(4)
    u8 = rng.integers(0, 256, (6, 5, 3), dtype=np.uint8)
    words = pack_rgba32(torch.from_numpy(u8)).numpy()
    expect = (u8[..., 0].astype(np.uint32) | u8[..., 1].astype(np.uint32) << 8
              | u8[..., 2].astype(np.uint32) << 16)
    assert np.array_equal(words, expect)


def test_plain_tail_zeroes_bytes_past_c():
    """Planar words of a c=1 frame carry the channel in byte 0 and zeros
    in bytes 1..3, like the TPU kernel's packing."""
    p, y, lr = _case(8, 8, 1, seed=2)
    args = _torch_args(p, y, lr)
    out = packed_tail_fused_reference(args[0][None], args[1][None],
                                      *args[2:])
    assert out.dtype == torch.uint32 and out.shape == (1, 4, 32, 8)
    b = out.view(torch.uint8).reshape(1, 4, 32, 8, 4)
    assert int(b[..., 1:].max()) == 0 and float(b[..., 0].float().std()) > 0
