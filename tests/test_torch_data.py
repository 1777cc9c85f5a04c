"""The port's data pipeline (bicubic_interpolation_model_tpu_torch/data/
{div2k,onthefly,validate}.py) against the JAX package on the CPU.

Tolerances: X (the host float64 downsample, then /255) and the offsets are
bit-equal; the GT weights ≤1e-6 (≤1e-5 adaptive: the luma-contrast factors
and the renormalisation add f32 roundings); the .bin files of X and the
offsets byte-equal and metadata.json equal; validation reports equal."""

import json

import numpy as np
import pytest
import torch

from bicubic_interpolation_model_tpu.data import div2k as jax_div2k
from bicubic_interpolation_model_tpu.data import onthefly as jax_onthefly
from bicubic_interpolation_model_tpu.data import validate as jax_validate
from bicubic_interpolation_model_tpu_torch.data import binfmt, div2k, \
    onthefly, validate
from bicubic_interpolation_model_tpu_torch.utils import imageio


def _hr(seed, h, w):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    img[..., 3] = 255
    # smooth regions and an edge, so the adaptive factors take all laws
    img[: h // 2, : w // 2, :3] = 120
    img[h // 2:, : w // 3, :3] = 250
    return img


@pytest.mark.parametrize("adaptive", [False, True])
def test_generate_sample_matches_jax(adaptive):
    hr = _hr(0, 48, 64)
    jx, joff, jy = jax_div2k.generate_sample(hr, 4, "cubic", adaptive)
    tx, toff, ty = div2k.generate_sample(hr, 4, "cubic", adaptive,
                                         device="cpu")
    assert tx.dtype == toff.dtype == ty.dtype == np.float32
    np.testing.assert_array_equal(tx, jx)
    np.testing.assert_array_equal(toff, joff)
    assert ty.shape == jy.shape == (48, 64, 16)
    np.testing.assert_allclose(ty, jy, rtol=0,
                               atol=1e-5 if adaptive else 1e-6)


def test_generate_sample_crops_to_the_scale():
    hr = _hr(1, 50, 67)
    tx, toff, ty = div2k.generate_sample(hr, 4, device="cpu")
    assert tx.shape == (12, 16, 4) and toff.shape == (48, 64, 2)
    np.testing.assert_array_equal(div2k.align_crop(hr, 4),
                                  jax_div2k.align_crop(hr, 4))


def _hr_dir(tmp_path):
    src = tmp_path / "hr"
    src.mkdir()
    imageio.save_png(src / "0001.png", _hr(2, 40, 52))
    imageio.save_png(src / "0002.png", _hr(3, 37, 45))
    (src / "0003.png").write_bytes(b"not a png")     # logged and skipped
    (src / "notes.txt").write_text("ignored")
    return src


@pytest.mark.parametrize("adaptive", [False, True])
def test_process_images_writes_the_jax_packages_files(tmp_path, adaptive):
    src = _hr_dir(tmp_path)
    jlog, tlog = [], []
    jrec = jax_div2k.process_images(src, tmp_path / "jax", adaptive=adaptive,
                                    log=jlog.append)
    trec = div2k.process_images(src, tmp_path / "port", adaptive=adaptive,
                                log=tlog.append, device="cpu")
    assert [r.__dict__ for r in trec] == [r.__dict__ for r in jrec]
    assert [r.sample_id for r in trec] == ["0001", "0002"]
    assert any(m.startswith("Error processing 0003.png") for m in tlog)
    assert len(tlog) == len(jlog)
    jroot, troot = tmp_path / "jax" / "train", tmp_path / "port" / "train"
    assert json.loads((troot / "metadata.json").read_text()) == json.loads(
        (jroot / "metadata.json").read_text())
    for sid in ("0001", "0002"):
        for kind in ("X", "offset"):
            assert (troot / kind / f"{sid}.bin").read_bytes() == (
                jroot / kind / f"{sid}.bin").read_bytes()
        np.testing.assert_allclose(
            binfmt.read_tensor(troot / "Y" / f"{sid}.bin"),
            binfmt.read_tensor(jroot / "Y" / f"{sid}.bin"), rtol=0,
            atol=1e-5 if adaptive else 1e-6)


def test_process_images_needs_a_card_unless_cpu_is_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device works")
    src = _hr_dir(tmp_path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        div2k.process_images(src, tmp_path / "out", log=lambda *_: None)


def test_validation_reports_match_jax(tmp_path):
    src = _hr_dir(tmp_path)
    div2k.process_images(src, tmp_path / "ds", log=lambda *_: None,
                         device="cpu")
    root = tmp_path / "ds" / "train"
    # corrupt one sample: NaN weights and an X of the wrong height
    y = binfmt.read_tensor(root / "Y" / "0002.bin").copy()
    y[0, 0, 3] = np.nan
    binfmt.write_tensor(root / "Y" / "0002.bin", y)
    x = binfmt.read_tensor(root / "X" / "0002.bin")
    binfmt.write_tensor(root / "X" / "0002.bin", x[:-1])
    tlog, jlog = [], []
    trep = validate.validate_dataset(root, log=tlog.append)
    jrep = jax_validate.validate_dataset(root, log=jlog.append)
    assert [(r.sample_id, r.ok, r.errors) for r in trep] == [
        (r.sample_id, r.ok, r.errors) for r in jrep]
    assert tlog == jlog
    assert [r.ok for r in trep] == [True, False]
    assert len(trep[1].errors) == 2
    for sid in ("0001", "0002", "missing"):
        t, j = validate.validate_sample(root, sid), \
            jax_validate.validate_sample(root, sid)
        assert (t.ok, t.errors) == (j.ok, j.errors)


def test_load_hr_dir_and_target_tiles_match_jax(tmp_path):
    src = _hr_dir(tmp_path)
    for keep_hr in (False, True):
        t = onthefly.load_hr_dir(src, keep_hr=keep_hr, log=lambda *_: None)
        j = jax_onthefly.load_hr_dir(src, keep_hr=keep_hr,
                                     log=lambda *_: None)
        assert t.keys() == j.keys() == {"0001", "0002"}
        for k in t:
            assert t[k].keys() == j[k].keys()
            for name in t[k]:
                np.testing.assert_array_equal(t[k][name], j[k][name])
    toff, ty = onthefly.target_tiles(8, 4, device="cpu")
    joff, jy = jax_onthefly.target_tiles(8, 4)
    np.testing.assert_array_equal(toff.numpy(), joff)
    np.testing.assert_allclose(ty.numpy(), jy, rtol=0, atol=1e-6)
