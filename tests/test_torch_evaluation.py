"""The port's evaluation and I/O layer against the JAX package on the CPU:
``evaluation/metrics`` (bit-equal), ``evaluation/compare`` (byte-equal
``metrics_report.csv``), ``evaluation/model_analysis`` (``validate_model``,
``compare_model``: stats.json within 1e-5; ``models.zoo.load_model`` on all
nine committed checkpoints), ``models/tfjs_import`` on a TFJS directory
written here, ``data/binfmt``, ``utils/config`` and ``runtime/native`` (the
port's own build of the root ``csrc/`` sources)."""

import json
import pathlib
import re

import jax
import numpy as np
import pytest
import torch

from bicubic_interpolation_model_tpu.data import binfmt as jax_binfmt
from bicubic_interpolation_model_tpu.evaluation import compare as jax_compare
from bicubic_interpolation_model_tpu.evaluation import metrics as jax_metrics
from bicubic_interpolation_model_tpu.evaluation import (
    model_analysis as jax_analysis)
from bicubic_interpolation_model_tpu.models import (
    tfjs_import as jax_tfjs)
from bicubic_interpolation_model_tpu.models.weight_predictor import (
    init_params as jax_init_params)
from bicubic_interpolation_model_tpu.utils import config as jax_config
from bicubic_interpolation_model_tpu_torch.data import binfmt
from bicubic_interpolation_model_tpu_torch.evaluation import compare
from bicubic_interpolation_model_tpu_torch.evaluation import metrics
from bicubic_interpolation_model_tpu_torch.evaluation import model_analysis
from bicubic_interpolation_model_tpu_torch.models import tfjs_import
from bicubic_interpolation_model_tpu_torch.models.mlp_predictor import (
    load_mlp)
from bicubic_interpolation_model_tpu_torch.models.zoo import load_model
from bicubic_interpolation_model_tpu_torch.ops.learned import (
    gt_weight_map, offset_map)
from bicubic_interpolation_model_tpu_torch.runtime import native
from bicubic_interpolation_model_tpu_torch.serving import ModelUpscaler
from bicubic_interpolation_model_tpu_torch.utils import config, imageio

ROOT = pathlib.Path(__file__).resolve().parents[1]
MODEL_DIR = ROOT / "model"


def _image(rng, h, w, c=4):
    img = rng.integers(0, 256, (h, w, c), dtype=np.uint8)
    if c == 4:
        img[..., 3] = 255
    return img


def _pair(rng, h, w, noise):
    """An HR frame with gradients, edges and texture, and a rebuild of it
    off by seeded noise of up to ``noise`` u8."""
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([(x * 255 // max(w - 1, 1)), (y * 255 // max(h - 1, 1)),
                     ((x // 7 + y // 5) % 2) * 200], -1).astype(np.int64)
    base = np.clip(base + rng.integers(-20, 21, base.shape), 0, 255)
    hr = np.concatenate([base, np.full((h, w, 1), 255)], -1).astype(np.uint8)
    rb = np.clip(hr.astype(np.int64)
                 + rng.integers(-noise, noise + 1, hr.shape), 0, 255)
    rb[..., 3] = 255
    return hr, rb.astype(np.uint8)


@pytest.mark.parametrize("h,w,noise", [(32, 48, 6), (300, 260, 3),
                                       (520, 780, 12), (24, 24, 0)])
def test_metrics_bit_equal_to_jax(h, w, noise):
    rng = np.random.default_rng(h + w)
    a, b = _pair(rng, h, w, noise)
    ref = jax_metrics.compare_images(a, b)
    got = metrics.compare_images(a, b)
    assert (got.psnr, got.ssim, got.mse) == (ref.psnr, ref.ssim, ref.mse)
    assert np.array_equal(metrics.to_gray_bt601(a),
                          jax_metrics.to_gray_bt601(a))
    assert metrics.ssim(metrics.to_gray_bt601(a), metrics.to_gray_bt601(b),
                        downsample=False) == jax_metrics.ssim(
        jax_metrics.to_gray_bt601(a), jax_metrics.to_gray_bt601(b),
        downsample=False)
    if noise == 0:
        assert got.psnr == float("inf")
    with pytest.raises(ValueError, match="size mismatch"):
        metrics.compare_images(a, b[1:])


def _cp_image_tree(root, rng):
    ids, methods = ["0001", "0002"], ["bicubic", "esrgan_lite", "missing"]
    for k, image_id in enumerate(ids):
        hr, _ = _pair(rng, 40 + 8 * k, 56, 0)
        imageio.save_png(root / "hr_images" / f"{image_id}.png", hr)
        for j, method in enumerate(methods[:2]):
            _, rb = _pair(rng, 40 + 8 * k, 56, 3 + 5 * j)
            imageio.save_png(root / "rebuild_hr_images" / image_id
                             / f"{method}.png", rb)
    # an identical rebuild: +inf PSNR counts as 100 dB in the averages
    imageio.save_png(root / "rebuild_hr_images" / "0001" / "copy.png",
                     imageio.load_rgba(root / "hr_images" / "0001.png"))
    return ids, methods + ["copy"]


def test_run_comparison_csv_byte_equal_to_jax(tmp_path):
    ids, methods = _cp_image_tree(tmp_path / "cp_image",
                                  np.random.default_rng(9))
    csvs, diffs = [], []
    for mod, tag in ((jax_compare, "jax"), (compare, "port")):
        logs = []
        res = mod.run_comparison(tmp_path / "cp_image", ids, methods,
                                 log=logs.append)
        assert [r.error is None for r in res] == [
            m != "missing" and not (m == "copy" and i == "0002")
            for i in ids for m in methods]
        out = tmp_path / tag / "metrics_report.csv"
        mod.export_csv(out, res, mod.method_averages(res))
        csvs.append(out.read_bytes())
        diffs.append({p.name: p.read_bytes() for p in sorted(
            (tmp_path / "cp_image" / "or_diff").glob("*.png"))})
    assert csvs[0] == csvs[1]
    assert b"AVERAGE,copy,100.00" in csvs[1]
    assert diffs[0] == diffs[1] and len(diffs[1]) == 5
    rng = np.random.default_rng(3)
    a, b = _image(rng, 9, 11), _image(rng, 9, 11)
    assert np.array_equal(compare.diff_image(a, b),
                          jax_compare.diff_image(a, b))


def _data_root(root, rng, n=2, h=6, w=7, s=4):
    """A training-data tree (X, offset, Y, metadata.json) written with the
    port's binfmt."""
    for k in range(n):
        sid = f"{k + 1:04d}"
        x = rng.uniform(0, 1, (h, w, 4)).astype(np.float32)
        x[..., 3] = 1.0
        off = offset_map(h * s, w * s, float(s), "train", device="cpu")
        y = gt_weight_map(h * s, w * s, float(s), "train", device="cpu")
        binfmt.write_tensor(root / "X" / f"{sid}.bin", x)
        binfmt.write_tensor(root / "offset" / f"{sid}.bin", off.numpy())
        binfmt.write_tensor(root / "Y" / f"{sid}.bin", y.numpy())
        binfmt.update_metadata(root / "metadata.json", sid, h, w, h * s,
                               w * s)
        hr = (np.clip(np.repeat(np.repeat(x, s, 0), s, 1), 0, 1)
              * 255).astype(np.uint8)
        imageio.save_png(root.parent / "hr" / f"{sid}.png", hr)


def _numbers(lines):
    return [float(v) for line in lines
            for v in re.findall(r"-?\d+\.\d+", line)]


def test_validate_and_compare_model_match_jax(tmp_path):
    root = tmp_path / "data"
    _data_root(root, np.random.default_rng(5))
    ckpt = MODEL_DIR / "wp-1e-3-120"
    logs_j, logs_t = [], []
    ok_j = jax_analysis.validate_model(ckpt, root, hr_dir=tmp_path / "hr",
                                       log=logs_j.append)
    ok_t = model_analysis.validate_model(ckpt, root, hr_dir=tmp_path / "hr",
                                         log=logs_t.append, device="cpu")
    assert ok_j == ok_t
    assert len(logs_t) == len(logs_j) and any("rebuild vs HR" in line
                                              for line in logs_t)
    assert np.allclose(_numbers(logs_t), _numbers(logs_j), rtol=0,
                       atol=2e-4)
    stats_j = jax_analysis.compare_model(ckpt, root, tmp_path / "j",
                                         log=lambda *_: None)
    stats_t = model_analysis.compare_model(ckpt, root, tmp_path / "t",
                                           log=lambda *_: None, device="cpu")
    on_disk = json.loads((tmp_path / "t" / "stats.json").read_text())
    assert on_disk == stats_t
    assert stats_t["samples"] == stats_j["samples"] == ["0001", "0002"]
    for key in ("global_mse", "global_mae", "per_channel_mse"):
        assert np.allclose(stats_t[key], stats_j[key], rtol=0, atol=1e-5)
    # per_channel_pct_diff is in percent: within 1e-5 as a fraction
    assert np.allclose(np.array(stats_t["per_channel_pct_diff"]) / 100,
                       np.array(stats_j["per_channel_pct_diff"]) / 100,
                       rtol=0, atol=1e-5)
    for name in ("comparison.txt", "weight_histograms.png"):
        assert (tmp_path / "t" / name).exists()
    pred = model_analysis.predict_weight_map(
        ckpt, binfmt.read_tensor(root / "X" / "0001.bin"),
        binfmt.read_tensor(root / "offset" / "0001.bin"), device="cpu")
    ref = jax_analysis.predict_weight_map(
        ckpt, jax_binfmt.read_tensor(root / "X" / "0001.bin"),
        jax_binfmt.read_tensor(root / "offset" / "0001.bin"))
    assert pred.shape == ref.shape == (24, 28, 16)
    assert np.abs(pred - ref).max() <= 1e-4


def _write_tfjs(model_dir, params):
    """A TFJS layers-format directory (model.json + two weight files) of a
    WeightPredictor's params, in the reference's manifest names."""
    names = {"conv_in": "conv2d_Conv2D1", "conv_res": "conv2d_Conv2D2",
             "upsample": "conv2d_transpose_Conv2DTranspose1",
             "conv_att": "conv2d_Conv2D3", "conv_off": "conv2d_Conv2D4",
             "conv_out": "conv2d_Conv2D5"}
    groups = [[], []]
    for i, (layer, tf_name) in enumerate(names.items()):
        for leaf in ("kernel", "bias"):
            a = np.asarray(params["params"][layer][leaf], np.float32)
            groups[i % 2].append((f"{tf_name}/{leaf}", a))
    manifest = []
    model_dir.mkdir(parents=True)
    for g, tensors in enumerate(groups):
        path = f"group{g + 1}-shard1of1.bin"
        (model_dir / path).write_bytes(b"".join(
            a.astype("<f4").tobytes() for _, a in tensors))
        manifest.append({"paths": [path], "weights": [
            {"name": n, "shape": list(a.shape), "dtype": "float32"}
            for n, a in tensors]})
    (model_dir / "model.json").write_text(json.dumps(
        {"format": "layers-model", "weightsManifest": manifest}))


def test_tfjs_import_matches_jax(tmp_path):
    _, jp = jax_init_params(jax.random.key(4), scale=4)
    d = tmp_path / "tfjs"
    _write_tfjs(d, jax.tree.map(np.asarray, jp))
    ref = jax_tfjs.read_tfjs_weights(d)
    got = tfjs_import.read_tfjs_weights(d)
    assert set(got) == set(ref) and len(got) == 12
    for k in ref:
        assert np.array_equal(got[k], ref[k])
    _, jparams = jax_tfjs.load_weight_predictor(d)
    model, params = tfjs_import.load_weight_predictor(d, device="cpu")
    for layer, leaves in jparams["params"].items():
        for k, v in leaves.items():
            assert np.array_equal(params["params"][layer][k].detach().numpy(),
                                  np.asarray(v))
    loaded, _ = load_model(d, device="cpu")
    assert type(loaded).__name__ == "WeightPredictor"
    up = ModelUpscaler(str(d), device="cpu")
    frame = _image(np.random.default_rng(1), 6, 5)
    assert up(frame).shape == (24, 20, 4)
    shard = d / "group2-shard1of1.bin"
    shard.write_bytes(shard.read_bytes() + b"\0" * 8)
    with pytest.raises(ValueError, match="size mismatch"):
        tfjs_import.read_tfjs_weights(d)


@pytest.mark.parametrize("name,kind", [
    ("wp-1e-3-120", "WeightPredictor"),
    ("wp-adaptive-1e-3-120", "WeightPredictor"),
    ("espcn_medium", "ESPCN"), ("espcn_thick", "ESPCNResidual"),
    ("esrgan_lite", "ESRGANLite"), ("esrgan_plus", "ESRGANLite"),
    ("srresnet_tpu", "SRResNetTPU"), ("patch-mlp", "PatchMLP"),
    ("pixel-mlp", "PixelMLP")])
def test_every_committed_checkpoint_loads(name, kind):
    meta = json.loads((MODEL_DIR / name / "meta.json").read_text())
    if "MLP" in kind:
        model, params, _ = load_mlp(MODEL_DIR / name, device="cpu")
        with pytest.raises(ValueError, match="load_mlp"):
            load_model(MODEL_DIR / name, device="cpu")
    else:
        model, params = load_model(MODEL_DIR / name, device="cpu")
    assert type(model).__name__ == kind
    assert meta["model"] in (kind, name)
    leaves = jax.tree.leaves(params)
    assert leaves and all(torch.isfinite(t).all() for t in leaves)


def test_binfmt_interchanges_with_jax(tmp_path):
    rng = np.random.default_rng(2)
    a = rng.normal(size=(5, 7, 16)).astype(np.float32)
    binfmt.write_tensor(tmp_path / "a.bin", a)
    jax_binfmt.write_tensor(tmp_path / "b.bin", a)
    assert (tmp_path / "a.bin").read_bytes() == (tmp_path / "b.bin"
                                                 ).read_bytes()
    assert np.array_equal(jax_binfmt.read_tensor(tmp_path / "a.bin"), a)
    assert np.array_equal(binfmt.read_tensor(tmp_path / "b.bin"), a)
    for mod, name in ((binfmt, "p.json"), (jax_binfmt, "j.json")):
        mod.update_metadata(tmp_path / name, "0001", 5, 7, 20, 28,
                            variant="x")
    assert (tmp_path / "p.json").read_text() == (tmp_path / "j.json"
                                                 ).read_text()
    trip = binfmt.load_triplets
    for sub in ("X", "offset", "Y"):
        binfmt.write_tensor(tmp_path / "t" / sub / "0001.bin", a)
    assert list(trip(tmp_path / "t")) == ["0001"]
    with pytest.raises(ValueError, match="HWC"):
        binfmt.write_tensor(tmp_path / "bad.bin", a[0])


def test_workspace_config_round_trip_matches_jax(tmp_path):
    cfg = config.WorkspaceConfig(hrid="0691", scale=3, a=-0.75)
    cfg.save(tmp_path)
    assert jax_config.WorkspaceConfig.load(tmp_path) == \
        jax_config.WorkspaceConfig(hrid="0691", scale=3, a=-0.75)
    assert config.WorkspaceConfig.load(tmp_path) == cfg
    assert config.WorkspaceConfig.load(tmp_path / "none") == \
        config.WorkspaceConfig()


def test_native_binding_round_trips_and_leaves_jax_package_alone(
        tmp_path, monkeypatch):
    """The port compiles the root csrc/ sources with its own g++ command
    into build/native/; it runs no make and writes nothing into the JAX
    package (whose own tests may build their library at the same time, so
    the commands are checked, not the directory)."""
    import subprocess
    jax_pkg = ROOT / "bicubic_interpolation_model_tpu"
    commands = []
    real_run = subprocess.run

    def run(argv, *args, **kwargs):
        commands.append([str(a) for a in argv])
        return real_run(argv, *args, **kwargs)
    monkeypatch.setattr(native.subprocess, "run", run)
    lib = native.build(force=True)
    monkeypatch.undo()
    assert lib.parent == ROOT / "build" / "native" and lib.exists()
    assert len(commands) == 1 and "make" not in commands[0][0]
    out = pathlib.Path(commands[0][commands[0].index("-o") + 1])
    assert out.parent == ROOT / "build" / "native"
    assert not any(str(jax_pkg) in a for a in commands[0])
    assert native.available()
    rng = np.random.default_rng(8)
    img = _image(rng, 19, 23)
    img[..., 3] = rng.integers(0, 256, (19, 23), dtype=np.uint8)
    assert native.encode_png(tmp_path / "a.png", img)
    assert np.array_equal(native.decode_png(tmp_path / "a.png"), img)
    from PIL import Image
    with Image.open(tmp_path / "a.png") as im:
        assert np.array_equal(np.asarray(im.convert("RGBA")), img)
    # RGB and gray go through PIL; loads come back RGBA
    imageio.save_png(tmp_path / "b.png", img[..., :3])
    assert np.array_equal(imageio.load_rgba(tmp_path / "b.png")[..., :3],
                          img[..., :3])
    # baseline JPEG: the native codec's decode within 2 u8 of PIL's (two
    # IDCTs) on a smooth frame with edges
    y, x = np.mgrid[0:40, 0:56]
    smooth = np.stack([x * 4, y * 6, ((x // 8 + y // 8) % 2) * 200,
                       np.full_like(x, 255)], -1).astype(np.uint8)
    imageio.save_image(tmp_path / "c.jpg", smooth)
    back = imageio.load_rgba(tmp_path / "c.jpg")
    with Image.open(tmp_path / "c.jpg") as im:
        pil = np.asarray(im.convert("RGBA"))
    assert back.shape == smooth.shape
    assert np.abs(back.astype(int) - pil).max() <= 2
    assert np.abs(back[..., :3].astype(int) - smooth[..., :3]).mean() < 2
    t = rng.normal(size=(3, 4, 2)).astype(np.float32)
    assert native.write_tensor_bin(tmp_path / "t.bin", t)
    assert np.array_equal(native.read_tensor_bin(tmp_path / "t.bin"), t)
