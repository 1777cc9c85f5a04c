"""The port's direct-regression SR models (ESPCN, ESPCNResidual, ESRGANLite,
SRResNetTPU: bicubic_interpolation_model_tpu_torch/models/{espcn,esrgan,
srresnet_tpu}.py), their inference (super_resolve_direct and the direct
branch of super_resolve_batch) and ModelUpscaler on them, against the JAX
package on the CPU: the five committed MODEL_ZOO checkpoints and small
random-init configurations carried across by params_from_jax.

Tolerance: ≤1 u8 with a share of differing values < 1e-3 (the same conv
stack summed in another order by another library), and bit-equal for
pixel_shuffle and the half-up rounding. bf16: the JAX package's envelope on
untrained weights (max ≤ 8, mean < 1.0 u8 from f32)."""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from bicubic_interpolation_model_tpu.evaluation.model_analysis import (
    _load_model_any as jax_load_model_any)
from bicubic_interpolation_model_tpu.models import espcn as jespcn
from bicubic_interpolation_model_tpu.models import esrgan as jesrgan
from bicubic_interpolation_model_tpu.models import srresnet_tpu as jsrres
from bicubic_interpolation_model_tpu.models.inference import (
    super_resolve_batch as jax_super_resolve_batch)
from bicubic_interpolation_model_tpu.models.inference import (
    super_resolve_direct as jax_super_resolve_direct)
from bicubic_interpolation_model_tpu.models.layers import (
    pixel_shuffle as jax_pixel_shuffle)
from bicubic_interpolation_model_tpu_torch.models.zoo import load_model
from bicubic_interpolation_model_tpu_torch.models import espcn, esrgan
from bicubic_interpolation_model_tpu_torch.models import srresnet_tpu
from bicubic_interpolation_model_tpu_torch.models.inference import (
    super_resolve, super_resolve_batch, super_resolve_direct)
from bicubic_interpolation_model_tpu_torch.models.layers import (
    numbered, pixel_shuffle)
from bicubic_interpolation_model_tpu_torch.serving import ModelUpscaler

MODEL_DIR = pathlib.Path(__file__).resolve().parents[1] / "model"
ZOO = ["espcn_medium", "espcn_thick", "esrgan_lite", "esrgan_plus",
       "srresnet_tpu"]
H, W = 16, 16        # one shape for every call: one XLA program per model


def _diff(a, b):
    d = np.abs(np.asarray(a).astype(np.int64) - np.asarray(b).astype(
        np.int64))
    return int(d.max()), float((d > 0).mean())


def _frames(n, c=3, seed=0, h=H, w=W):
    f = np.random.default_rng(seed).integers(0, 256, (n, h, w, c),
                                             dtype=np.uint8)
    if c == 4:
        f[..., 3] = 255
    return f


@pytest.fixture(scope="module")
def jax_zoo():
    return {}


def _jax_model(jax_zoo, name):
    """The JAX package's MODEL_ZOO module and the checkpoint's params as
    flax restores them (the bytes its loader reads, without the loader's
    init program, whose XLA compile is the slow part on the CPU)."""
    if name not in jax_zoo:
        raw = (MODEL_DIR / name / "params.msgpack").read_bytes()
        jax_zoo[name] = (jespcn.MODEL_ZOO[name](scale=4),
                         serialization.msgpack_restore(raw))
    return jax_zoo[name]


@pytest.mark.parametrize("name", ZOO)
def test_checkpoint_super_resolve_direct_matches_jax(jax_zoo, name):
    jm, jp = _jax_model(jax_zoo, name)
    model, params = load_model(MODEL_DIR / name, device="cpu")
    assert type(model).__name__ == type(jm).__name__
    img = _frames(1, seed=1)[0]
    ref = np.asarray(jax_super_resolve_direct(jm, jp, img))
    got = super_resolve_direct(model, params, img)
    assert got.dtype == torch.uint8 and got.shape == (4 * H, 4 * W, 3)
    mx, share = _diff(got, ref)
    assert mx <= 1 and share < 1e-3, (mx, share)
    assert float(got.float().std()) > 0
    # super_resolve dispatches a direct model to the same function
    assert torch.equal(super_resolve(model, params, img), got)


@pytest.mark.parametrize("name", ZOO)
def test_model_upscaler_serves_checkpoint_like_jax(jax_zoo, name):
    jm, jp = _jax_model(jax_zoo, name)
    up = ModelUpscaler(str(MODEL_DIR / name), device="cpu")
    assert up._direct and up._tail_operands is None
    frames = _frames(3, c=4, seed=2)
    refs = [np.asarray(jax_super_resolve_direct(jm, jp, f[..., :3]))
            for f in frames]
    one = up(frames[0])
    assert isinstance(one, np.ndarray) and one.shape == (4 * H, 4 * W, 3)
    for got, ref in ((one, refs[0]), (up(frames[1], fetch=False), refs[1])):
        mx, share = _diff(got, ref)
        assert mx <= 1 and share < 1e-3, (mx, share)
    singles = [up(f) for f in frames]
    batch = up.batch(frames)
    assert batch.shape == (3, 4 * H, 4 * W, 3)
    for b, s in zip(batch, singles):
        assert _diff(b, s)[0] <= 1
    for microbatch in ("auto", None):
        out = list(up.stream(iter(frames), microbatch=microbatch))
        assert len(out) == 3
        for o, s in zip(out, singles):
            assert _diff(o, s)[0] <= 1


def test_super_resolve_batch_matches_frames_and_jax(jax_zoo):
    jm, jp = _jax_model(jax_zoo, "espcn_thick")
    model, params = load_model(MODEL_DIR / "espcn_thick", device="cpu")
    frames = _frames(3, seed=3)
    got = super_resolve_batch(model, params, frames)
    assert got.shape == (3, 4 * H, 4 * W, 3) and got.dtype == torch.uint8
    for i, f in enumerate(frames):
        assert _diff(got[i], super_resolve_direct(model, params, f))[0] <= 1
    ref = np.asarray(jax_super_resolve_batch(jm, jp, frames))
    mx, share = _diff(got, ref)
    assert mx <= 1 and share < 1e-3, (mx, share)
    with pytest.raises(ValueError, match=r"\[B, H, W, C\]"):
        super_resolve_batch(model, params, frames[0])


def _small_configs():
    return [
        ("espcn16", lambda: jespcn.ESPCN(scale=4, features=16),
         lambda: espcn.ESPCN(scale=4, features=16), espcn.params_from_jax),
        ("espcn_residual", lambda: jespcn.ESPCNResidual(
            scale=2, features=16, n_blocks=2),
         lambda: espcn.ESPCNResidual(scale=2, features=16, n_blocks=2),
         espcn.params_from_jax),
        # scale 3 takes the odd step of the upsampling loop at once
        ("esrgan_scale3", lambda: jesrgan.ESRGANLite(
            scale=3, features=16, growth=8, n_blocks=2),
         lambda: esrgan.ESRGANLite(scale=3, features=16, growth=8,
                                   n_blocks=2), esrgan.params_from_jax),
        ("esrgan_scale4", lambda: jesrgan.ESRGANLite(
            scale=4, features=16, growth=8, n_blocks=1),
         lambda: esrgan.ESRGANLite(scale=4, features=16, growth=8,
                                   n_blocks=1), esrgan.params_from_jax),
        ("srresnet", lambda: jsrres.SRResNetTPU(
            scale=2, features=16, n_blocks=5),
         lambda: srresnet_tpu.SRResNetTPU(scale=2, features=16, n_blocks=5),
         srresnet_tpu.params_from_jax),
    ]


@pytest.mark.parametrize("case", _small_configs(), ids=lambda c: c[0])
def test_random_init_configs_carried_across(case):
    _, make_jax, make_port, from_jax = case
    jm = make_jax()
    jp = jm.init(jax.random.key(7), jnp.zeros((1, 8, 8, 3)))
    tree = jax.tree.map(np.asarray, jp)
    model = make_port()
    params = from_jax(tree, device="cpu")
    model.load_tree(params)
    # the module's tree holds the same leaves under the same names
    shapes = jax.tree.map(lambda a: tuple(a.shape), tree)["params"]
    mine = jax.tree.map(lambda t: tuple(t.shape), model.tree()["params"])
    assert mine == shapes
    img = _frames(1, seed=4, h=12, w=10)[0]
    ref = np.asarray(jax_super_resolve_direct(jm, jp, img))
    for p in (params, model.tree()):
        got = super_resolve_direct(model, p, img)
        assert got.shape == ref.shape
        mx, share = _diff(got, ref)
        assert mx <= 1 and share < 1e-3, (mx, share)


def test_jax_loader_restores_the_same_params(jax_zoo):
    _, ref = jax_load_model_any(str(MODEL_DIR / "espcn_thick"))
    _, raw = _jax_model(jax_zoo, "espcn_thick")
    same = jax.tree.map(lambda a, b: np.array_equal(np.asarray(a), b),
                        ref, raw)
    assert all(jax.tree.leaves(same))


def test_params_from_jax_refuses_another_family():
    _, p = load_model(MODEL_DIR / "esrgan_lite", device="cpu")
    with pytest.raises(ValueError, match="not an ESPCN tree"):
        espcn.params_from_jax(p, device="cpu")
    _, q = load_model(MODEL_DIR / "srresnet_tpu", device="cpu")
    with pytest.raises(ValueError, match="not an ESRGANLite tree"):
        esrgan.params_from_jax(q, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        espcn.ESPCN(features=16).load_tree(
            espcn.params_from_jax(load_model(
                MODEL_DIR / "espcn_medium", device="cpu")[1],
                device="cpu"))


def test_numbered_orders_by_integer_suffix():
    p = {f"Conv_{i}": {} for i in (0, 1, 10, 11, 2, 3, 4, 5, 6, 7, 8, 9)}
    assert numbered(p, "Conv") == [f"Conv_{i}" for i in range(12)]
    with pytest.raises(ValueError, match="0..n-1"):
        numbered({"Conv_0": {}, "Conv_2": {}}, "Conv")


@pytest.mark.parametrize("shape,s", [((2, 3, 5, 48), 4), ((1, 4, 4, 27), 3),
                                     ((3, 2, 7, 8), 2)])
def test_pixel_shuffle_bit_equal_to_jax(shape, s):
    x = np.random.default_rng(5).normal(size=shape).astype(np.float32)
    ref = np.asarray(jax_pixel_shuffle(jnp.asarray(x), s))
    got = pixel_shuffle(torch.from_numpy(x), s).numpy()
    assert got.shape == ref.shape and np.array_equal(got, ref)
    # torch's own pixel_shuffle orders channels otherwise
    nchw = torch.nn.functional.pixel_shuffle(
        torch.from_numpy(x).permute(0, 3, 1, 2), s).permute(0, 2, 3, 1)
    assert not np.array_equal(nchw.numpy(), ref)


class _JaxConst:
    """A direct "model" whose output is a fixed array (static under jit)."""

    def __init__(self, y):
        self.y = y

    def apply(self, params, x):
        return jnp.asarray(self.y)[None] + 0.0 * x[..., :1]


class _TorchConst:
    def __init__(self, y):
        self.y = torch.from_numpy(y)

    def apply(self, params, x):
        return self.y[None].to(x.dtype) + 0.0 * x[..., :1]


def test_rounding_is_half_up_at_exact_halves():
    # f32 values y with y*255 exactly n + 0.5 in f32 arithmetic
    ys, ns = [], []
    for n in range(255):
        y = np.float32((n + 0.5) / 255.0)
        for cand in (y, np.nextafter(y, np.float32(1)),
                     np.nextafter(y, np.float32(0))):
            if np.float32(cand) * np.float32(255.0) == np.float32(n + 0.5):
                ys.append(cand)
                ns.append(n)
                break
    assert len(ys) >= 32 and any(n % 2 == 0 for n in ns)
    y = np.array(ys, np.float32).reshape(1, -1, 1)
    expect = np.array(ns).reshape(1, -1, 1) + 1            # half up
    img = np.zeros(y.shape[:2] + (3,), np.uint8)
    ref = np.asarray(jax_super_resolve_direct(_JaxConst(y), {}, img))
    got = super_resolve_direct(_TorchConst(y), {"w": torch.zeros(1)}, img)
    assert np.array_equal(ref, expect) and np.array_equal(got.numpy(),
                                                          expect)
    # half-even rounding (the WeightPredictor path's) would differ
    assert not np.array_equal(np.round(y * np.float32(255.0)), expect)


def test_bf16_envelope_on_untrained_weights():
    jm = jespcn.ESPCN(scale=4, channels=3, features=16)
    jp = jm.init(jax.random.key(1), jnp.zeros((1, 8, 8, 3)))
    model = espcn.ESPCN(scale=4, features=16)
    params = espcn.params_from_jax(jp, device="cpu")
    img = _frames(1, seed=6, h=10, w=14)[0]
    f32 = super_resolve_direct(model, params, img)
    assert torch.equal(f32, super_resolve_direct(model, params, img))
    for dt in (torch.bfloat16, "bfloat16"):
        bf16 = super_resolve_direct(model, params, img, compute_dtype=dt)
        assert bf16.shape == f32.shape
        d = np.abs(f32.numpy().astype(np.int64) - bf16.numpy())
        assert d.max() <= 8 and d.mean() < 1.0
    jbf16 = np.asarray(jax_super_resolve_direct(jm, jp, img,
                                                compute_dtype="bfloat16"))
    d = np.abs(jbf16.astype(np.int64) - bf16.numpy())
    assert d.max() <= 8 and d.mean() < 1.0
    # float64 runs the same function as a reference
    f64 = super_resolve_direct(model, params, img,
                               compute_dtype=torch.float64)
    assert _diff(f64, f32)[0] <= 1


def test_direct_models_take_no_rgba32_layout():
    model, params = load_model(MODEL_DIR / "espcn_medium", device="cpu")
    with pytest.raises(ValueError, match="RGB"):
        super_resolve(model, params, _frames(1, c=4)[0], layout="hwc32")
