"""The port's packed tail on a precomputed merged map (kernel G's wrapper,
bicubic_interpolation_model_tpu_torch/ops/packed_tail.packed_tail) against
the JAX package's ``packed_tail_pallas`` run in interpret mode.

On the CPU the wrapper runs its plain PyTorch version,
``packed_tail_reference``. Tolerances, those of tests/test_packed_tail.py:
≤1 u8 LSB with a share of differing bytes < 1e-3 (the same f32 ops summed
in another order) and a non-constant output; layouts bit-equal to each
other. The CUDA kernel is held against the plain version on the card in
test_torch_kernels.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bicubic_interpolation_model_tpu.ops.pallas_packed_tail import (
    packed_tail_pallas)
from bicubic_interpolation_model_tpu_torch.ops.interleave import (
    rgba32_to_hwc_np)
from bicubic_interpolation_model_tpu_torch.ops.packed_tail import (
    packed_tail, packed_tail_reference)
from bicubic_interpolation_model_tpu_torch.ops.planar import unpack_planar


def _case(h, w, c, seed, halo="zero", opaque=False):
    """Numpy operands for both packages: map, pixels, conv_out."""
    rng = np.random.default_rng(seed)
    rows, lr_rows = (h + 2, h + 3) if halo == "rows" else (h, h)
    m = rng.normal(0, 0.5, (rows, w, 4, 4, 32)).astype(np.float32)
    lr = rng.integers(0, 256, (lr_rows, w, c)).astype(np.float32)
    if opaque:
        lr[..., 3] = 255.0
    kout = rng.normal(0, 0.05, (3, 3, 32, 16)).astype(np.float32)
    bout = rng.normal(0, 0.25, 16).astype(np.float32)
    return m, lr, kout, bout


def _jax(m, lr, kout, bout, **kw):
    return np.asarray(packed_tail_pallas(
        jnp.asarray(m), jnp.asarray(lr), jnp.asarray(kout),
        jnp.asarray(bout), interpret=True, **kw))


def _port(m, lr, kout, bout, **kw):
    return packed_tail(*(torch.from_numpy(a) for a in (m, lr, kout, bout)),
                       **kw)


def _close(got, ref):
    d = np.abs(np.asarray(got).astype(np.int64) - ref.astype(np.int64))
    return d.max() <= 1 and (d != 0).mean() < 1e-3


@pytest.mark.parametrize("h,w,c", [(24, 40, 4), (19, 37, 4), (13, 9, 3),
                                   (8, 128, 1)])
def test_zero_halo_matches_pallas(h, w, c):
    args = _case(h, w, c, seed=h * 31 + w)
    ref = _jax(*args)
    got = _port(*args).numpy()
    assert got.shape == ref.shape == (h * 4, w * 4, c)
    assert _close(got, ref) and got.std() > 0


def test_rows_halo_on_a_band_cut_from_a_frame_matches_pallas():
    """A band's operands cut from one frame's map and pixels as the sharded
    path cuts them: map rows [-1, hb+1) and pixels [-1, hb+2) of band 1 of
    3; with real rows there, the band's bytes are the frame's."""
    m, lr, kout, bout = _case(18, 20, 4, seed=5)
    hb, r0 = 6, 6
    band = (m[r0 - 1:r0 + hb + 1], lr[r0 - 1:r0 + hb + 2], kout, bout)
    ref = _jax(*band, halo="rows")
    got = _port(*band, halo="rows").numpy()
    assert got.shape == ref.shape == (hb * 4, 80, 4)
    assert _close(got, ref)
    frame = _port(m, lr, kout, bout).numpy()
    assert np.array_equal(got, frame[r0 * 4:(r0 + hb) * 4])


def test_layouts_and_opaque_alpha_match_pallas():
    args = _case(11, 21, 4, seed=7, halo="rows", opaque=True)
    for kw in ({"layout": "hwc32"}, {"opaque_alpha": True}):
        ref = _jax(*args, halo="rows", **kw)
        got = _port(*args, halo="rows", **kw).numpy()
        if kw.get("layout") == "hwc32":
            ref = rgba32_to_hwc_np(ref, 44, 84)
            got = rgba32_to_hwc_np(got, 44, 84)
        assert _close(got, ref)
    planar = _port(*args, halo="rows", layout="planar")
    assert planar.shape == (4, 44, 21) and planar.dtype == torch.uint32
    hwc = _port(*args, halo="rows")
    assert torch.equal(unpack_planar(planar, 11, 21, 4, 4), hwc)
    words = _port(*args, halo="rows", layout="hwc32")
    assert np.array_equal(rgba32_to_hwc_np(words.numpy(), 44, 84),
                          hwc.numpy())
    # opaque alpha keeps the colour bytes and sets alpha = rint(255 sum(w))
    opq = _port(*args, halo="rows", opaque_alpha=True)
    assert torch.equal(opq[..., :3], hwc[..., :3])


def test_bf16_map_matches_pallas():
    """A bf16 map: conv_out rounds to bf16 and accumulates in f32 in both
    packages, so they agree as the f32 forms do."""
    m, lr, kout, bout = _case(16, 24, 4, seed=9)
    ref = np.asarray(packed_tail_pallas(
        jnp.asarray(m, jnp.bfloat16), jnp.asarray(lr), jnp.asarray(kout),
        jnp.asarray(bout), interpret=True))
    got = packed_tail(torch.from_numpy(m).to(torch.bfloat16),
                      *(torch.from_numpy(a) for a in (lr, kout, bout)))
    assert _close(got.numpy(), ref)


def test_plain_version_is_what_the_wrapper_runs_on_the_cpu():
    args = [torch.from_numpy(a) for a in _case(9, 10, 1, seed=3)]
    before = packed_tail.launches
    planar = packed_tail(*args, layout="planar")
    assert torch.equal(planar.view(torch.int32),
                       packed_tail_reference(*args).view(torch.int32))
    assert packed_tail.launches == before
    b = planar.view(torch.uint8).reshape(4, 36, 10, 4)
    assert int(b[..., 1:].max()) == 0 and float(b[..., 0].float().std()) > 0
    # a leading batch of one is dropped, as the JAX function drops it
    assert torch.equal(packed_tail(args[0][None], *args[1:]),
                       packed_tail(*args))


def test_refuses_what_the_kernel_does_not_take():
    m, lr, kout, bout = (torch.from_numpy(a)
                         for a in _case(8, 8, 4, seed=1, halo="rows"))
    with pytest.raises(ValueError, match="h\\+3"):
        packed_tail(m, lr[:-1], kout, bout, halo="rows")
    with pytest.raises(ValueError, match="c<=4"):
        packed_tail(m, torch.zeros(11, 8, 5), kout, bout, halo="rows")
    with pytest.raises(ValueError, match="S\\*2F==128"):
        packed_tail(m[..., :16], lr, kout, bout, halo="rows")
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        packed_tail(m.double(), lr, kout, bout, halo="rows")
    with pytest.raises(ValueError, match="kout"):
        packed_tail(m, lr, kout[0], bout, halo="rows")
    with pytest.raises(ValueError, match="halo"):
        packed_tail(m, lr, kout, bout, halo="same")
    with pytest.raises(ValueError, match="layout"):
        packed_tail(m, lr, kout, bout, halo="rows", layout="chw")
    with pytest.raises(ValueError, match="describe one"):
        packed_tail(m, lr, kout, bout)           # zero halo: lr rows == h
