"""The port's CLI (bicubic_interpolation_model_tpu_torch/cli) against the JAX
package's CLI on the CPU: the parser trees, and the workspace files that
make-lr, sr and eval leave on a small synthetic workspace.

Tolerances: the parsers are equal (subcommands; per action its option
strings, dest, default, choices, required, nargs and type). make-lr's LR
is within 1 u8 of the JAX CLI's (the downsample's contract,
tests/test_torch_downsample.py; this frame's ramps put many values on a
rounding tie); on the same LR file, sr's nearest rebuild
is byte-equal, bicubic and adaptive within 1 u8; eval's
``metrics_report.csv`` on the same rebuilt images is byte-equal; both
CLIs leave the same workspace tree."""

import pathlib
import shutil

import numpy as np
import pytest

from bicubic_interpolation_model_tpu.cli import main as jcli
from bicubic_interpolation_model_tpu_torch.cli import main as tcli
from bicubic_interpolation_model_tpu_torch.utils import imageio

HR = (96, 128)


def _actions(parser):
    out = {}
    for a in parser._actions:
        if a.dest == "help":
            continue
        out[a.dest] = (tuple(a.option_strings), a.default,
                       tuple(a.choices) if a.choices is not None
                       and not isinstance(a.choices, dict) else None,
                       a.required, a.nargs, a.type)
    return out


def _subparsers(parser):
    sub = next(a for a in parser._actions if a.dest == "cmd")
    return sub.choices


def test_parser_tree_equals_jax():
    jp, tp = jcli.build_parser(), tcli.build_parser()
    assert tp.prog == jp.prog
    assert _actions(tp).keys() == _actions(jp).keys()
    assert _actions(tp) == _actions(jp)
    js, ts = _subparsers(jp), _subparsers(tp)
    assert list(ts) == list(js)
    assert len(ts) == 11
    for name in js:
        assert _actions(ts[name]) == _actions(js[name]), name
        # each subcommand's function is the port's own, of the same name
        jf, tf = js[name].get_default("func"), ts[name].get_default("func")
        assert tf.__name__ == jf.__name__
        assert tf.__module__ == tcli.__name__


@pytest.mark.parametrize("argv", [
    ["sr", "--method", "bicubic", "--scale", "2.5", "--runs", "1"],
    ["train", "--epochs", "3", "--mode", "image"],
    ["bench"], ["eval", "--image-ids", "a", "b", "--methods"],
    ["data", "--hr-dir", "x", "--split", "test", "--adaptive"]])
def test_parsed_arguments_equal_jax(argv):
    j = vars(jcli.build_parser().parse_args(["--cpu"] + argv))
    t = vars(tcli.build_parser().parse_args(["--cpu"] + argv))
    assert j.pop("func").__name__ == t.pop("func").__name__
    assert t == j


def test_without_cpu_and_without_a_card_a_command_raises(tmp_path):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["--workspace", str(tmp_path), "bench", "--runs", "1"])


def _workspace(root: pathlib.Path) -> pathlib.Path:
    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[0:HR[0], 0:HR[1]]
    hr = np.stack([(xx * 2) % 256, (yy * 3) % 256, (xx + yy) % 256,
                   np.full(HR, 255)], -1).astype(np.int64)
    hr[:, HR[1] // 2:, :3] = rng.integers(0, 256, (HR[0], HR[1] // 2, 3))
    imageio.save_png(root / "cp_image" / "hr_images" / "0001.png",
                     hr.astype(np.uint8))
    return root


def _tree(root):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*")
                  if p.is_file())


def _png(path):
    return imageio.load_rgba(path).astype(np.int64)


def test_make_lr_sr_and_eval_leave_the_jax_cli_files(tmp_path):
    jws = _workspace(tmp_path / "jax")
    tws = _workspace(tmp_path / "port")
    for cli, ws in ((jcli, jws), (tcli, tws)):
        cli.main(["--workspace", str(ws), "--cpu", "make-lr",
                  "--image-id", "0001"])
    lr_name = pathlib.Path("cp_image/lr_images/0001_downsample.png")
    d = np.abs(_png(tws / lr_name) - _png(jws / lr_name))
    assert d.max() <= 1
    # the same LR file for both from here on
    shutil.copy(jws / lr_name, tws / lr_name)

    for method in ("nearest", "bicubic", "adaptive"):
        for cli, ws in ((jcli, jws), (tcli, tws)):
            cli.main(["--workspace", str(ws), "--cpu", "sr", "--image-id",
                      "0001", "--method", method, "--runs", "1"])
    rebuilt = pathlib.Path("cp_image/rebuild_hr_images/0001")
    for name, tol in (("nearest", 0), ("bicubic_-0.5", 1),
                      ("adaptive_bicubic_-0.5", 1)):
        got, want = _png(tws / rebuilt / f"{name}.png"), _png(
            jws / rebuilt / f"{name}.png")
        assert got.shape == want.shape == HR + (4,)
        assert np.abs(got - want).max() <= tol, name

    # eval on the same rebuilt images: the CSV byte-equal
    shutil.rmtree(tws / rebuilt)
    shutil.copytree(jws / rebuilt, tws / rebuilt)
    for cli, ws in ((jcli, jws), (tcli, tws)):
        cli.main(["--workspace", str(ws), "eval"])
    csv = pathlib.Path("cp_image/metrics_report.csv")
    assert (tws / csv).read_bytes() == (jws / csv).read_bytes()
    assert (tws / csv).read_text().startswith(
        "IMAGE_ID,METHOD,PSNR(dB),SSIM,MSE\n0001,")
    assert _tree(tws) == _tree(jws)
    for perf in ("nearest", "bsr", "adaptive_bicubic"):
        rows = (tws / "cp_performance" / perf /
                f"{perf}_performance.csv").read_text().splitlines()
        assert rows[0] == ("Run,Timestamp,Execution Time (ms),"
                           "CPU Time (ms),Memory (MB)") and len(rows) == 2


def test_sr_refuses_a_fractional_scale_for_adaptive(tmp_path):
    ws = _workspace(tmp_path)
    tcli.main(["--workspace", str(ws), "--cpu", "make-lr", "--image-id",
               "0001"])
    with pytest.raises(SystemExit, match="integer --scale"):
        tcli.main(["--workspace", str(ws), "--cpu", "sr", "--image-id",
                   "0001", "--method", "adaptive", "--scale", "2.5"])
    tcli.main(["--workspace", str(ws), "--cpu", "sr", "--image-id", "0001",
               "--method", "lanczos", "--scale", "2.5", "--runs", "1",
               "--output", str(ws / "out.png")])
    assert _png(ws / "out.png").shape == (60, 80, 4)
