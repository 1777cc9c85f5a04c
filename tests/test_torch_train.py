"""The port's trainers (bicubic_interpolation_model_tpu_torch/train/
{trainer,direct_trainer,mlp_trainer}.py) against the JAX package's on the
CPU: the same parameters (carried across by tree_from_jax) and the same
batches through one and five steps, the batches fit draws, the
learning-rate schedule, the augmented batches, the MLP trainer's history
and early stop, and the initial parameters' distributions.

Tolerances. After one step: parameters rtol 2e-5 / atol 2e-6 (the JAX
package's own between two numerically equal steps, tests/test_parallel.py
:268-271); the loss ≤1e-6 relative of the float64 loss of the JAX forward's
prediction. The JAX f32 loss itself is further off: XLA's CPU reduction
sums the 10^5 terms with 4e-6 to 1.3e-5 relative error here, the port's
pairwise sum with ~1e-7; the JAX loss is held within 1e-4 of the float64
value, the five-step tolerance. After five steps: losses ≤1e-4 relative,
parameters atol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from bicubic_interpolation_model_tpu.models import espcn as jespcn
from bicubic_interpolation_model_tpu.models import esrgan as jesrgan
from bicubic_interpolation_model_tpu.models import mlp_predictor as jmlp
from bicubic_interpolation_model_tpu.models import srresnet_tpu as jsrres
from bicubic_interpolation_model_tpu.models.weight_predictor import (
    WeightPredictor as JWeightPredictor)
from bicubic_interpolation_model_tpu.ops.adaptive import (
    adaptive_gt_factors as jax_adaptive_gt_factors)
from bicubic_interpolation_model_tpu.ops.learned import (
    gt_weight_map as jax_gt_weight_map, offset_map as jax_offset_map)
from bicubic_interpolation_model_tpu.train import direct_trainer as jdt
from bicubic_interpolation_model_tpu.train import mlp_trainer as jmt
from bicubic_interpolation_model_tpu.train import trainer as jtr
from bicubic_interpolation_model_tpu_torch.models import espcn, esrgan
from bicubic_interpolation_model_tpu_torch.models import mlp_predictor
from bicubic_interpolation_model_tpu_torch.models import srresnet_tpu
from bicubic_interpolation_model_tpu_torch.models.layers import tree_to_numpy
from bicubic_interpolation_model_tpu_torch.models.weight_predictor import (
    WeightPredictor)
from bicubic_interpolation_model_tpu_torch.train import direct_trainer as dt
from bicubic_interpolation_model_tpu_torch.train import mlp_trainer as mt
from bicubic_interpolation_model_tpu_torch.train import trainer as tr

S = 4


def _leaf_diffs(jparams, tparams):
    """Max |a - b| and max |a - b| / (atol + rtol |a|) over leaves matched
    by path."""
    a = jax.tree_util.tree_flatten_with_path(jax.device_get(jparams))[0]
    b = tree_to_numpy(tparams)
    worst_abs, worst_rel = 0.0, 0.0
    for path, leaf in a:
        node = b
        for k in path:
            node = node[k.key]
        d = np.abs(np.asarray(leaf) - node)
        worst_abs = max(worst_abs, float(d.max()))
        worst_rel = max(worst_rel, float(
            (d / (2e-6 + 2e-5 * np.abs(np.asarray(leaf)))).max()))
    return worst_abs, worst_rel


def _wp_batch(rng, b=2, p=16, partial_mask=False):
    img = rng.random((b, p, p, 4), np.float32)
    n = p * S
    off = np.broadcast_to(np.asarray(jax_offset_map(n, n, float(S),
                                                    "train"))[None],
                          (b, n, n, 2)).copy()
    y = np.broadcast_to(np.asarray(jax_gt_weight_map(n, n, float(S)))[None],
                        (b, n, n, 16)).copy()
    mask = np.ones((b, n, n, 1), np.float32)
    if partial_mask:       # the padded rows and columns of an image batch
        mask[1, 40:] = 0.0
        mask[0, :, 52:] = 0.0
    return img, off, y, mask


def _wp_params(seed=0):
    return JWeightPredictor(scale=S).init(
        jax.random.key(seed), jnp.zeros((1, 8, 8, 4)),
        jnp.zeros((1, 8 * S, 8 * S, 2)))


def _loss64(pred, target, mask=None):
    err = np.asarray(pred, np.float64) - np.asarray(target, np.float64)
    if mask is None:
        return float((err ** 2).mean())
    err = err * mask
    return float((err ** 2).sum() / max(mask.sum() * target.shape[-1], 1.0))


@pytest.mark.parametrize("case", ["patch", "image_partial_mask", "adaptive",
                                  "remat"])
def test_weight_predictor_step_matches_jax(case):
    rng = np.random.default_rng(1)
    img, off, y, mask = _wp_batch(rng, partial_mask=case != "patch")
    adaptive, remat = case == "adaptive", case == "remat"
    jm = JWeightPredictor(scale=S)
    params = _wp_params()
    opt = optax.adam(1e-4)
    jstep = jtr.make_weight_predictor_step(jm, opt, adaptive=adaptive,
                                           scale=S, remat=remat)
    tstep = tr.make_weight_predictor_step(WeightPredictor(scale=S),
                                          adaptive=adaptive, scale=S,
                                          remat=remat)
    # the float64 loss of the JAX forward at the starting parameters
    target = y
    if adaptive:
        f = np.stack([np.asarray(jax_adaptive_gt_factors(im, S))
                      for im in img])
        w = y.astype(np.float64) * f
        s = w.sum(-1, keepdims=True)
        target = np.where(s > 0, w / np.where(s > 0, s, 1), 0.0)
    ref64 = _loss64(jm.apply(params, img, off), target, mask)

    jp, jo = params, opt.init(params)
    tp = tr.trainable(params, "cpu")
    to = tr.adam(1e-4).init(tp)
    jl, tl = [], []
    for k in range(5):
        jp, jo, jloss, _ = jstep(jp, jo, img, off, y, mask)
        tp, to, tloss, _ = tstep(tp, to, img, off, y, mask)
        jl.append(float(jloss))
        tl.append(float(tloss))
        if k == 0:
            d_abs, d_rel = _leaf_diffs(jp, tp)
            assert d_rel <= 1.0, (d_abs, d_rel)
            assert abs(tl[0] - ref64) <= 1e-6 * ref64
            assert abs(jl[0] - ref64) <= 1e-4 * ref64
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert _leaf_diffs(jp, tp)[0] <= 1e-5
    assert tl[-1] < tl[0]


def test_remat_step_equals_plain_step():
    """torch.utils.checkpoint recomputes the same forward: the step is bit
    for bit the plain step's (as jax.checkpoint's is in the JAX package)."""
    img, off, y, mask = _wp_batch(np.random.default_rng(2))
    params = _wp_params(1)
    out = []
    for remat in (False, True):
        step = tr.make_weight_predictor_step(WeightPredictor(scale=S),
                                             remat=remat)
        tp = tr.trainable(params, "cpu")
        to = tr.adam(1e-4).init(tp)
        for _ in range(2):
            tp, to, loss, mae = step(tp, to, img, off, y, mask)
        out.append((float(loss), float(mae), tree_to_numpy(tp)))
    assert out[0][:2] == out[1][:2]
    jax.tree.map(np.testing.assert_array_equal, out[0][2], out[1][2])


def _dataset(rng, shapes, stored):
    data = {}
    for i, (h, w) in enumerate(shapes):
        d = {"X": rng.random((h, w, 4), np.float32)}
        if stored:
            d["offset"] = np.asarray(jax_offset_map(h * S, w * S, float(S),
                                                    "train"))
            d["Y"] = rng.random((h * S, w * S, 16), np.float32)
        data[f"img{i}"] = d
    return data


def _recorder(batches, result):
    def step(params, opt_state, img, off, y, mask):
        batches.append(tuple(np.array(a) if not isinstance(a, torch.Tensor)
                             else a.cpu().numpy() for a in (img, off, y,
                                                            mask)))
        return (params, opt_state) + result
    return step


@pytest.mark.parametrize("mode", ["patch", "patch_synth", "image",
                                  "image_grouped_synth"])
def test_fit_draws_the_jax_trainers_batches(mode):
    """Both trainers' fit see the same batches, in the same order, from the
    same seed: images and masks bit-equal, offsets bit-equal, synthesised
    weight targets within 1e-6."""
    rng = np.random.default_rng(3)
    shapes = [(20, 24), (17, 30), (23, 19)]
    data = _dataset(rng, shapes, stored=mode in ("patch", "image"))
    cfg_kw = dict(patch_lr=8, batch_size=3, bucket=8, seed=7)
    if mode.startswith("image"):
        cfg_kw.update(mode="image",
                      image_batch=2 if mode == "image_grouped_synth" else 1)
    if mode == "image_grouped_synth":     # two of three share a bucket
        data["img2"]["X"] = rng.random((21, 29), np.float32)[..., None] \
            .repeat(4, -1)
    jt = jtr.WeightPredictorTrainer(JWeightPredictor(scale=S),
                                    jtr.TrainConfig(**cfg_kw))
    tt = tr.WeightPredictorTrainer(WeightPredictor(scale=S),
                                   tr.TrainConfig(**cfg_kw), device="cpu")
    jb, tb = [], []
    jt.step_fn = _recorder(jb, (jnp.float32(0), jnp.float32(0)))
    tt.step_fn = _recorder(tb, (torch.zeros(()), torch.zeros(())))
    params = _wp_params()
    jt.fit(data, params=params, epochs=2, log=lambda *_: None)
    tt.fit(data, params=params, epochs=2, log=lambda *_: None)
    assert len(jb) == len(tb) >= 4
    for a, b in zip(jb, tb):
        assert all(x.shape == z.shape for x, z in zip(a, b))
        for i in (0, 1, 3):
            np.testing.assert_array_equal(a[i], b[i])
        np.testing.assert_allclose(a[2], b[2], rtol=0, atol=1e-6)


def test_fit_trains_on_the_cpu_and_keeps_the_callers_tree():
    data = _dataset(np.random.default_rng(4), [(24, 24)], stored=False)
    params = tr.trainable(_wp_params(), "cpu")
    before = tree_to_numpy(params)
    t = tr.WeightPredictorTrainer(
        WeightPredictor(scale=S), tr.TrainConfig(patch_lr=8, batch_size=2),
        device="cpu")
    out = t.fit(data, params=params, epochs=3, log=lambda *_: None)
    assert [r["epoch"] for r in t.history] == [1, 2, 3]
    assert t.history[-1]["loss"] < t.history[0]["loss"]
    jax.tree.map(np.testing.assert_array_equal, before,
                 tree_to_numpy(params))
    assert out is not params


def test_trainers_need_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tr.WeightPredictorTrainer(WeightPredictor(scale=S))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dt.DirectSRTrainer(espcn.ESPCN(features=8))


DIRECT = {
    "espcn": (lambda: jespcn.ESPCN(scale=S, features=16),
              lambda: espcn.ESPCN(scale=S, features=16)),
    "srresnet": (lambda: jsrres.SRResNetTPU(scale=S, features=16,
                                            n_blocks=1),
                 lambda: srresnet_tpu.SRResNetTPU(scale=S, features=16,
                                                  n_blocks=1)),
    "esrgan": (lambda: jesrgan.ESRGANLite(scale=S, features=16, growth=8,
                                          n_blocks=1),
               lambda: esrgan.ESRGANLite(scale=S, features=16, growth=8,
                                         n_blocks=1)),
}


@pytest.mark.parametrize("name", list(DIRECT))
def test_direct_step_matches_jax(name):
    """Adam under the decaying rate of DirectSRConfig (steps_per_epoch 2,
    so the rate moves within the five steps). DirectSRConfig's rate, 1e-3,
    is ten times TrainConfig's, and Adam moves a leaf by up to the rate per
    step, so after five steps the parameters are held at ten times the
    weight predictor's atol: 1e-4, 2% of the most five steps can move a
    leaf, as 1e-5 is at 1e-4. (A leaf whose gradient is near Adam's eps,
    1e-8, moves by less than the rate and amplifies the two libraries'
    f32 differences: ESRGANLite's upsample conv ``Conv_3`` here.)"""
    make_j, make_t = DIRECT[name]
    jnet, tnet = make_j(), make_t()
    rng = np.random.default_rng(5)
    lr = rng.random((2, 12, 12, 3), np.float32)
    hr = rng.random((2, 12 * S, 12 * S, 3), np.float32)
    params = jnet.init(jax.random.key(2), jnp.zeros((1, 8, 8, 3)))
    cfg_kw = dict(steps_per_epoch=2, lr_decay=0.5)
    jtrainer = jdt.DirectSRTrainer(jnet, jdt.DirectSRConfig(**cfg_kw))
    ttrainer = dt.DirectSRTrainer(tnet, dt.DirectSRConfig(**cfg_kw),
                                  device="cpu")
    ref64 = _loss64(jnet.apply(params, lr), hr)
    jp, jo = params, jtrainer.optimizer.init(params)
    tp = tr.trainable(params, "cpu")
    to = ttrainer.optimizer.init(tp)
    jl, tl = [], []
    for k in range(5):
        jp, jo, jloss, _ = jtrainer.step_fn(jp, jo, lr, hr)
        tp, to, tloss, _ = ttrainer.step_fn(tp, to, lr, hr)
        jl.append(float(jloss))
        tl.append(float(tloss))
        if k == 0:
            assert _leaf_diffs(jp, tp)[1] <= 1.0
            assert abs(tl[0] - ref64) <= 1e-6 * ref64
            assert abs(jl[0] - ref64) <= 1e-4 * ref64
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert _leaf_diffs(jp, tp)[0] <= 1e-5 * (jtrainer.cfg.learning_rate
                                             / 1e-4)


def test_learning_rate_schedule_is_optax_exponential_decay():
    t_per, decay, lr0 = 4, 0.97, 1e-3
    sched = optax.exponential_decay(lr0, t_per, decay)
    state = tr.adam(lr0, decay_steps=t_per, decay_rate=decay).init(
        {"w": torch.zeros(3, requires_grad=True)})
    rates = {}
    for t in range(11):
        rates[t] = state.learning_rate
        state.step()
    for t in (0, t_per, int(2.5 * t_per)):
        assert rates[t] == pytest.approx(float(sched(t)), rel=1e-6)
    assert rates[int(2.5 * t_per)] == pytest.approx(lr0 * decay ** 2.5,
                                                    rel=1e-12)


def test_augmented_batches_are_the_jax_trainers():
    rng = np.random.default_rng(6)
    hr = rng.integers(0, 256, (64, 80, 4), dtype=np.uint8)
    data = {"a": {"X": rng.random((16, 20, 4), np.float32), "HR": hr},
            "b": {"X": rng.random((16, 20, 4), np.float32), "HR": hr}}
    cfg = dict(patch_lr=6, batch_size=24, augment=True)
    jtrainer = jdt.DirectSRTrainer(jespcn.ESPCN(features=8),
                                   jdt.DirectSRConfig(**cfg))
    ttrainer = dt.DirectSRTrainer(espcn.ESPCN(features=8),
                                  dt.DirectSRConfig(**cfg), device="cpu")
    ra, rb = np.random.default_rng(9), np.random.default_rng(9)
    for _ in range(3):
        ja = jtrainer._batch(data, ["a", "b"], ra)
        ta = ttrainer._batch(data, ["a", "b"], rb)
        for x, z in zip(ja, ta):
            np.testing.assert_array_equal(x, z)


def _mlp_case(n=1536, f=66, seed=8):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, f)).astype(np.float32)
    w = rng.standard_normal((f, 16)).astype(np.float32) / 8
    return x, (np.tanh(x @ w) + 1.0).astype(np.float32)


@pytest.mark.parametrize("case", ["two_epochs", "early_stop"])
def test_train_pixel_mlp_matches_jax(case):
    x, y = _mlp_case()
    kw = dict(batch_size=512, seed=3)
    if case == "two_epochs":
        kw.update(epochs=2, learning_rate=0.05)
    else:       # no epoch improves by min_delta: patience 5 stops it
        kw.update(epochs=30, learning_rate=0.05, min_delta=1.0)
    jparams, jhist = jmt.train_pixel_mlp(jmlp.PixelMLP(), x, y,
                                         jmt.MLPTrainConfig(**kw),
                                         log=lambda *_: None)
    params0 = jmlp.PixelMLP().init(jax.random.key(kw["seed"]),
                                   jnp.zeros((1, x.shape[1])))
    tparams, thist = mt.train_pixel_mlp(
        mlp_predictor.PixelMLP(), x, y, mt.MLPTrainConfig(**kw),
        log=lambda *_: None, params=params0, device="cpu")
    assert len(thist) == len(jhist)
    np.testing.assert_allclose(thist, jhist, rtol=1e-5)
    if case == "early_stop":
        assert len(thist) < kw["epochs"]
    else:
        assert _leaf_diffs(jparams, tparams)[0] <= 1e-5


def test_train_pixel_mlp_draws_its_own_init_and_applies_max_norm():
    x, y = _mlp_case(n=512, f=64)
    with pytest.raises(ValueError, match="66 features"):
        mt.train_pixel_mlp(mlp_predictor.PixelMLP(), x, y,
                           mt.MLPTrainConfig(epochs=1), device="cpu")
    params, hist = mt.train_pixel_mlp(
        mlp_predictor.PixelMLP(n_in=64), x, y,
        mt.MLPTrainConfig(epochs=2, learning_rate=0.5, max_norm=0.5),
        log=lambda *_: None, device="cpu")
    assert len(hist) == 2 and np.isfinite(hist).all()
    for layer in params["params"].values():
        norms = torch.linalg.vector_norm(layer["kernel"].detach(), dim=0)
        assert float(norms.max()) <= 0.5 + 1e-6


def _pooled_stds(trees):
    out = {}
    for path, _ in jax.tree_util.tree_flatten_with_path(trees[0])[0]:
        if path[-1].key != "kernel":
            continue
        name = "/".join(k.key for k in path)
        vals = []
        for t in trees:
            node = t
            for k in path:
                node = node[k.key]
            vals.append(np.asarray(node, np.float64).ravel())
        out[name] = float(np.concatenate(vals).std())
    return out


@pytest.mark.parametrize("model", ["WeightPredictor", "PixelMLP"])
def test_initial_parameters_follow_flax_distributions(model):
    """Per-layer kernel standard deviations (lecun-normal convs, the
    glorot-uniform upsample, he-normal dense layers) within 5% of flax's,
    each pooled over 256 seeds; biases start at zero in both."""
    n = 256
    if model == "WeightPredictor":
        jm, tm = JWeightPredictor(scale=S), WeightPredictor(scale=S)
        args = (jnp.zeros((1, 8, 8, 4)), jnp.zeros((1, 32, 32, 2)))
    else:
        jm, tm = jmlp.PixelMLP(), mlp_predictor.PixelMLP()
        args = (jnp.zeros((1, 66)),)
    keys = jax.random.split(jax.random.key(0), n)
    jtrees = jax.vmap(lambda k: jm.init(k, *args))(keys)
    jtrees = [jax.tree.map(lambda a, i=i: np.asarray(a[i]), jtrees)
              for i in range(n)]
    ttrees = [tree_to_numpy(tr.fresh_params(tm, "cpu", seed))
              for seed in range(n)]
    js, ts = _pooled_stds(jtrees), _pooled_stds(ttrees)
    assert js.keys() == ts.keys() and len(js) >= 3
    for k in js:
        assert abs(ts[k] - js[k]) <= 0.05 * js[k], (k, ts[k], js[k])
    for t in ttrees[:2]:
        for layer in t["params"].values():
            if "bias" in layer:
                assert not layer["bias"].any()
