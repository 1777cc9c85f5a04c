"""The port's MLP weight predictors (bicubic_interpolation_model_tpu_torch/
models/mlp_predictor.py: PatchMLP, PixelMLP, apply_max_norm,
extract_pixel_features, super_resolve_mlp, load_mlp) against the JAX
package on the CPU, on the committed patch-mlp and pixel-mlp checkpoints
and on random weights.

Tolerance: patch features bit-equal (the same slices), offsets 1e-6 (XLA
may divide by a non-power-of-two scale through its reciprocal), max-norm
1e-6 and dense outputs 1e-5 (f32 norms and products in another order), SR
≤1 u8 with a share < 1e-3."""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bicubic_interpolation_model_tpu.models import mlp_predictor as J
from bicubic_interpolation_model_tpu.train import checkpoint as jax_checkpoint
from bicubic_interpolation_model_tpu_torch.models import mlp_predictor as T

MODEL_DIR = pathlib.Path(__file__).resolve().parents[1] / "model"
CKPTS = [("patch-mlp", J.PatchMLP, 64, False), ("pixel-mlp", J.PixelMLP, 66,
                                                 True)]


def _jax_ckpt(name, cls, n_feat):
    model = cls()
    tmpl = model.init(jax.random.key(0), np.zeros((1, n_feat), np.float32))
    params, _ = jax_checkpoint.load(MODEL_DIR / name, tmpl)
    return model, params


def _frame(h, w, c, seed):
    f = np.random.default_rng(seed).integers(0, 256, (h, w, c),
                                             dtype=np.uint8)
    if c == 4:
        f[..., 3] = 255
    return f


@pytest.mark.parametrize("convention", ["train", "inference"])
@pytest.mark.parametrize("h,w,c,scale", [(7, 9, 4, 4), (5, 6, 3, 3)])
def test_extract_pixel_features_matches_jax(h, w, c, scale, convention):
    lr = _frame(h, w, c, seed=h * w).astype(np.float32) / 255.0
    h_sr, w_sr = h * scale - 1, w * scale      # a cropped height too
    ref = np.asarray(J.extract_pixel_features(lr, h_sr, w_sr, scale,
                                              convention))
    got = T.extract_pixel_features(torch.from_numpy(lr), h_sr, w_sr, scale,
                                   convention).numpy()
    assert got.shape == ref.shape == (h_sr * w_sr, 16 * c + 2)
    assert np.array_equal(got[:, :-2], ref[:, :-2])
    assert np.abs(got[:, -2:] - ref[:, -2:]).max() <= 1e-6


@pytest.mark.parametrize("name,cls,n_feat,include_offsets", CKPTS)
def test_super_resolve_mlp_matches_jax_on_checkpoint(name, cls, n_feat,
                                                     include_offsets):
    jm, jp = _jax_ckpt(name, cls, n_feat)
    model, params, inc = T.load_mlp(MODEL_DIR / name, device="cpu")
    assert inc == include_offsets
    assert type(model).__name__ == cls.__name__
    for i, (h, w) in enumerate([(13, 11), (8, 20)]):
        img = _frame(h, w, 4, seed=i)
        ref = np.asarray(J.super_resolve_mlp(jm, jp, img, scale=4,
                                             include_offsets=inc))
        got = T.super_resolve_mlp(model, params, img, scale=4,
                                  include_offsets=inc)
        assert got.dtype == torch.uint8 and got.shape == ref.shape
        d = np.abs(got.numpy().astype(np.int64) - ref)
        assert d.max() <= 1 and (d > 0).mean() < 1e-3
        assert float(got.float().std()) > 0


@pytest.mark.parametrize("name,cls,n_feat,include_offsets", CKPTS)
@pytest.mark.parametrize("max_norm", [3.0, 0.5])
def test_apply_max_norm_matches_jax(name, cls, n_feat, include_offsets,
                                    max_norm):
    _, jp = _jax_ckpt(name, cls, n_feat)
    _, params, _ = T.load_mlp(MODEL_DIR / name, device="cpu")
    ref = J.apply_max_norm(jp, max_norm)
    got = T.apply_max_norm(params, max_norm)
    flat_ref = dict(jax.tree_util.tree_leaves_with_path(ref))
    flat_got = dict(jax.tree_util.tree_leaves_with_path(got))
    before = dict(jax.tree_util.tree_leaves_with_path(jp))
    assert set(flat_ref) == set(flat_got)
    changed = 0
    for path, leaf in flat_ref.items():
        mine = flat_got[path].detach().numpy()
        assert np.abs(mine - np.asarray(leaf)).max() <= 1e-6
        changed += not np.array_equal(np.asarray(leaf),
                                      np.asarray(before[path]))
        if path[-1].key == "kernel":
            assert np.linalg.norm(mine, axis=0).max() <= max_norm + 1e-5
    if max_norm < 1.0:
        assert changed > 0


@pytest.mark.parametrize("jax_cls,port_cls,n_feat",
                         [(J.PatchMLP, T.PatchMLP, 64),
                          (J.PixelMLP, T.PixelMLP, 66)])
def test_random_init_mlp_matches_flax(jax_cls, port_cls, n_feat):
    jm = jax_cls()
    jp = jm.init(jax.random.key(3), jnp.zeros((1, n_feat)))
    model = port_cls(generator=torch.Generator().manual_seed(0))
    shapes = jax.tree.map(lambda a: tuple(a.shape), jp)["params"]
    mine = jax.tree.map(lambda t: tuple(t.shape), model.tree()["params"])
    assert mine == shapes
    model.load_tree(jp)
    x = np.random.default_rng(4).normal(size=(50, n_feat)).astype(np.float32)
    ref = np.asarray(jm.apply(jp, jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert np.abs(got - ref).max() <= 1e-5


def test_load_mlp_refuses_other_checkpoints():
    with pytest.raises(ValueError, match="not an MLP predictor"):
        T.load_mlp(MODEL_DIR / "espcn_medium", device="cpu")
