"""The port's CLI (bicubic_interpolation_model_tpu_torch/cli) on its learned
and training commands, on the CPU: ``sr --method model`` and the direct
models against the JAX package's CLI on the same LR file, and
data → validate-data → train → validate-model → compare-model and
train-sr on a small synthetic HR directory.

Tolerances: ``sr --method model`` on model/wp-1e-3-120 within 2 u8 of the
JAX CLI's rebuild (the packed path's contract against the exact program),
``sr --method espcn_medium`` within 1 u8 (the direct models' contract);
the checkpoints that ``train`` and ``train-sr`` write load in the JAX
package's ``train.checkpoint.load`` with the same values as in the
port's."""

import json
import pathlib
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bicubic_interpolation_model_tpu.cli import main as jcli
from bicubic_interpolation_model_tpu.models import espcn as jespcn
from bicubic_interpolation_model_tpu.models.weight_predictor import (
    init_params as jax_init_params)
from bicubic_interpolation_model_tpu.train import checkpoint as jax_ckpt
from bicubic_interpolation_model_tpu_torch.cli import main as tcli
from bicubic_interpolation_model_tpu_torch.train import checkpoint
from bicubic_interpolation_model_tpu_torch.utils import imageio

MODEL = pathlib.Path(__file__).resolve().parents[1] / "model"


def _lr_workspace(root, seed=4):
    rng = np.random.default_rng(seed)
    lr = rng.integers(0, 256, (20, 28, 4), dtype=np.uint8)
    lr[..., 3] = 255
    imageio.save_png(root / "cp_image" / "lr_images" / "0001_downsample.png",
                     lr)
    return root


def _png(path):
    return imageio.load_rgba(path).astype(np.int64)


@pytest.mark.parametrize("method,model_dir,tol", [
    ("model", "wp-1e-3-120", 2), ("espcn_medium", "espcn_medium", 1)])
def test_sr_learned_matches_the_jax_cli(tmp_path, method, model_dir, tol):
    outs = []
    for cli, name in ((jcli, "jax"), (tcli, "port")):
        ws = _lr_workspace(tmp_path / name)
        cli.main(["--workspace", str(ws), "--cpu", "sr", "--image-id", "0001",
                  "--method", method, "--model-dir", str(MODEL / model_dir),
                  "--runs", "1"])
        outs.append(_png(ws / "cp_image" / "rebuild_hr_images" / "0001" /
                         f"{model_dir if method == 'model' else method}.png"))
        perf = ws / "cp_performance" / method / f"{method}_performance.csv"
        assert perf.read_text().startswith("Run,Timestamp,")
    assert outs[0].shape == outs[1].shape == (80, 112, 4)
    assert np.abs(outs[0] - outs[1]).max() <= tol
    assert outs[1].std() > 0


def _hr_dir(root, n=2, hw=(64, 80)):
    rng = np.random.default_rng(7)
    yy, xx = np.mgrid[0:hw[0], 0:hw[1]]
    for i in range(n):
        img = np.stack([(xx * (3 + i)) % 256, (yy * 5) % 256,
                        rng.integers(0, 256, hw), np.full(hw, 255)], -1)
        imageio.save_png(root / f"{i:04d}.png", img.astype(np.uint8))
    return root


def test_data_train_validate_compare_and_train_sr(tmp_path, capsys):
    ws, hr = tmp_path / "ws", _hr_dir(tmp_path / "hr")
    run = lambda *argv: tcli.main(["--workspace", str(ws), "--cpu", *argv])
    run("data", "--hr-dir", str(hr))
    assert sorted(p.name for p in (ws / "data" / "train" / "X").iterdir()) \
        == ["0000.bin", "0001.bin"]
    run("validate-data")
    assert "2/2 samples valid" in capsys.readouterr().out
    run("train", "--epochs", "1", "--patch-lr", "16", "--batch-size", "2",
        "--resume", str(MODEL / "wp-1e-3-120"))
    out = ws / "model" / "wp"
    meta = json.loads((out / "meta.json").read_text())
    assert meta["model"] == "WeightPredictor" and meta["scale"] == 4
    jargs = vars(jcli.build_parser().parse_args(["train"]))
    assert set(meta["config"]) == set(jargs) and meta["config"]["func"] is None
    assert len(meta["history"]) == 1
    tree, _ = checkpoint.load(out)
    jtree, jmeta = jax_ckpt.load(out, jax_init_params(jax.random.key(0))[1])
    assert jmeta == meta
    jax.tree.map(np.testing.assert_array_equal, jax.device_get(jtree), tree)
    # fine-tuned one step from the committed checkpoint: weights sum to ~1
    with pytest.raises(SystemExit) as e:
        run("validate-model", "--model-dir", str(out), "--split", "train",
            "--hr-dir", str(hr))
    assert e.value.code == 0
    run("compare-model", "--model-dir", str(out), "--split", "train")
    cmp_dir = ws / "cp_model" / "wp"
    assert {p.name for p in cmp_dir.iterdir()} >= {"comparison.txt",
                                                   "stats.json"}

    run("train-sr", "--hr-dir", str(hr), "--epochs", "1", "--patch-lr", "8",
        "--batch-size", "2")
    d = ws / "model" / "espcn_medium"
    dtree, dmeta = checkpoint.load(d)
    assert dmeta["model"] == "espcn_medium" and len(dmeta["history"]) == 1
    template = jespcn.MODEL_ZOO["espcn_medium"](scale=4).init(
        jax.random.key(0), jnp.zeros((1, 8, 8, 3)))
    jd, _ = jax_ckpt.load(d, template)
    jax.tree.map(np.testing.assert_array_equal, jax.device_get(jd), dtree)
    # the trained direct model serves through sr
    shutil.copy(hr / "0000.png", tmp_path / "lr.png")
    run("sr", "--input", str(tmp_path / "lr.png"), "--output",
        str(tmp_path / "sr.png"), "--method", "espcn_medium", "--model-dir",
        str(d), "--runs", "1")
    sr = _png(tmp_path / "sr.png")
    assert sr.shape == (256, 320, 4) and (sr[..., 3] == 255).all()
