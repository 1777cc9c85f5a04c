"""The port's learned SR inference (bicubic_interpolation_model_tpu_torch/
models/inference.py) against the JAX package on the committed
``model/wp-1e-3-120`` checkpoint, frames made by numpy from a seed.

Tolerances: the exact path ≤1 u8 LSB (the same f32 program, summed in
another order); the packed path ≤1 LSB with a share of differing bytes
< 1e-3 vs the JAX packed forward with either tail; bf16 model stages ≤3
LSB vs f32 (the JAX package's bf16 envelope); layouts and batches
bit-equal to the per-frame HWC result."""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bicubic_interpolation_model_tpu.evaluation.model_analysis import (
    _load_model_any as jax_load_model_any)
from bicubic_interpolation_model_tpu.models import inference as J
from bicubic_interpolation_model_tpu_torch.entry import entry
from bicubic_interpolation_model_tpu_torch.models.zoo import load_model
from bicubic_interpolation_model_tpu_torch.models import inference as T
from bicubic_interpolation_model_tpu_torch.models.weight_predictor import (
    init_params)

CKPT = pathlib.Path(__file__).resolve().parents[1] / "model" / "wp-1e-3-120"


@pytest.fixture(scope="module")
def jax_wp():
    return jax_load_model_any(str(CKPT))


@pytest.fixture(scope="module")
def port_wp():
    return load_model(CKPT, device="cpu")


def _frame(seed, h=40, w=56, c=4):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (h, w, c), dtype=np.uint8)
    if c == 4:
        img[..., 3] = 255
    return img


def _d(a, b):
    d = np.abs(np.asarray(a).astype(np.int64) - np.asarray(b).astype(np.int64))
    return d.max(), (d != 0).mean()


@pytest.mark.parametrize("convention", ["train", "inference"])
def test_exact_matches_jax(jax_wp, port_wp, convention):
    img = _frame(1, 12, 16)
    ref = J.super_resolve(*jax_wp, img, convention=convention, exact=True)
    got = T.super_resolve(*port_wp, img, convention=convention, exact=True)
    assert got.dtype == torch.uint8 and got.shape == (48, 64, 4)
    assert _d(got.numpy(), ref)[0] <= 1


@pytest.mark.parametrize("jax_tail,port_tail", [("xla", "graph"),
                                                ("pallas", "kernel")])
def test_packed_matches_jax(jax_wp, port_wp, jax_tail, port_tail):
    """f32 packed forward: the port's graph tail vs the JAX XLA tail, and
    the port's kernel wrapper (its plain version on the CPU) vs the Pallas
    tail in interpret mode."""
    img = _frame(2)
    ref = J._super_resolve_packed(jax_wp[1], jnp.asarray(img), 4, "train",
                                  tail=jax_tail)
    got = T._super_resolve_packed(port_wp[1], torch.as_tensor(img), 4,
                                  "train", tail=port_tail)
    mx, share = _d(got.numpy(), ref)
    assert mx <= 1 and share < 1e-3
    assert got.numpy().std() > 0


def test_packed_tails_agree(port_wp):
    img = torch.as_tensor(_frame(3, 24, 40))
    g = T._super_resolve_packed(port_wp[1], img, 4, "inference", tail="graph")
    k = T._super_resolve_packed(port_wp[1], img, 4, "inference", tail="kernel")
    assert torch.equal(g, k)
    with pytest.raises(ValueError, match="tail"):
        T._super_resolve_packed(port_wp[1], img, 4, "train", tail="pallas")


def test_kernel_tail_raises_on_shapes_it_does_not_take():
    """tail='kernel' never gives way to the graph: a 2x WeightPredictor
    (S*2F = 64, not 128) is not the kernel's, so it raises; 'auto' and
    'graph' serve it."""
    _, params = init_params(torch.Generator().manual_seed(0), scale=2,
                            device="cpu")
    img = torch.as_tensor(_frame(12, 8, 10))
    with pytest.raises(ValueError, match="tail='kernel'"):
        T._super_resolve_packed(params, img, 2, "train", tail="kernel")
    g = T._super_resolve_packed(params, img, 2, "train", tail="graph")
    a = T._super_resolve_packed(params, img, 2, "train", tail="auto")
    assert g.shape == (16, 20, 4) and torch.equal(a, g)


@pytest.mark.parametrize("tail", ["graph", "kernel"])
def test_bf16_stays_in_envelope(port_wp, tail):
    img = _frame(4)
    f32 = T.super_resolve(*port_wp, img, convention="train", tail=tail)
    bf = T.super_resolve(*port_wp, img, convention="train", tail=tail,
                         compute_dtype=torch.bfloat16)
    assert _d(bf.numpy(), f32.numpy())[0] <= 3


@pytest.mark.parametrize("exact", [False, True])
def test_hwc32_bytes_equal_hwc_bytes(port_wp, exact):
    img = _frame(5, 12, 16)
    hwc = T.super_resolve(*port_wp, img, convention="train", exact=exact)
    h32 = T.super_resolve(*port_wp, img, convention="train", exact=exact,
                          layout="hwc32")
    assert h32.dtype == torch.uint32 and h32.shape == (48, 64)
    assert torch.equal(h32.view(torch.uint8).reshape(48, 64, 4), hwc)


def test_layout_errors(port_wp):
    with pytest.raises(ValueError, match="layout must be"):
        T.super_resolve(*port_wp, _frame(6, 8, 8), layout="planar")
    with pytest.raises(ValueError, match="RGBA frames only"):
        T.super_resolve(*port_wp, _frame(6, 8, 8, 3), layout="hwc32")


@pytest.mark.parametrize("exact", [False, True])
def test_batch_equals_per_frame(port_wp, exact):
    imgs = np.stack([_frame(7, 12, 16), _frame(8, 12, 16)])
    got = T.super_resolve_batch(*port_wp, imgs, convention="train",
                                exact=exact)
    assert got.shape == (2, 48, 64, 4)
    for i in range(2):
        one = T.super_resolve(*port_wp, imgs[i], convention="train",
                              exact=exact)
        assert torch.equal(got[i], one)
    with pytest.raises(ValueError):
        T.super_resolve_batch(*port_wp, imgs[0], convention="train")


def test_opaque_alpha_changes_alpha_only(port_wp):
    img = _frame(9, 16, 24)
    a = T.super_resolve(*port_wp, img, convention="train", tail="kernel")
    b = T.super_resolve(*port_wp, img, convention="train", tail="kernel",
                        opaque_alpha=True)
    assert torch.equal(a[..., :3], b[..., :3])
    assert _d(a[..., 3].numpy(), b[..., 3].numpy())[0] <= 1


def test_predict_weights_matches_jax(jax_wp, port_wp):
    img = _frame(10, 10, 12)
    ref = np.asarray(J.predict_weights(*jax_wp, img, convention="train"))
    got = T.predict_weights(*port_wp, img, convention="train").numpy()
    assert got.shape == ref.shape == (40, 48, 16)
    assert np.abs(got - ref).max() <= 1e-4


def test_entry_serves_the_packed_forward():
    forward, (params, lr) = entry(device="cpu")
    out = forward(params, lr)
    assert out.dtype == torch.uint8 and out.shape == (128, 128, 4)
    assert lr.shape == (32, 32, 4) and lr.dtype == torch.uint8


def test_packed_merged_map_matches_einsum_oracle(jax_wp, port_wp):
    """The flat merged map (what the graph tail runs) vs the einsum
    formulation ``_packed_upsample_att`` + the per-phase offset constant,
    and that oracle vs the JAX package's: ≤1e-4 on up-lanes (reduction
    order), offset lanes exact."""
    rng = np.random.default_rng(11)
    y = rng.normal(0, 0.5, (1, 6, 7, 32)).astype(np.float32)
    p = port_wp[1]["params"]
    yt = torch.as_tensor(y)
    with torch.no_grad():
        m = T.packed_merged_map(p, yt, 4, "train")
        att = T._packed_upsample_att(p, yt)
        off = T._packed_off_feat(p, 4, "train")
    jatt = np.asarray(J._packed_upsample_att(jax_wp[1]["params"],
                                             jnp.asarray(y)))
    assert m.shape == (1, 6, 7, 4, 4, 32)
    assert np.abs(att.numpy() - jatt).max() <= 1e-5
    assert np.abs(m[..., :16].numpy() - att.numpy()).max() <= 1e-4
    assert torch.equal(m[..., 16:], off.expand(1, 6, 7, 4, 4, 16))
