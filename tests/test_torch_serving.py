"""The port's ModelUpscaler (bicubic_interpolation_model_tpu_torch/
serving.py) on the CPU, the port's device rule, and its import hygiene.

Tolerance: every serving entry point returns bytes equal to
``super_resolve`` on the same frame (one program, one device)."""

import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from bicubic_interpolation_model_tpu_torch.models.inference import (
    super_resolve)
from bicubic_interpolation_model_tpu_torch.serving import (
    ModelUpscaler, Upscaler, _fetch, _start_fetch)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CKPT = ROOT / "model" / "wp-1e-3-120"


@pytest.fixture(scope="module")
def up():
    return ModelUpscaler(str(CKPT), device="cpu")


def _frames(n, h=12, w=16, c=4, seed=0):
    rng = np.random.default_rng(seed)
    f = rng.integers(0, 256, (n, h, w, c), dtype=np.uint8)
    if c == 4:
        f[..., 3] = 255
    return f


def test_call_batch_stream_agree_with_super_resolve(up):
    frames = _frames(3)
    ref = [super_resolve(up.model, up.params, f, convention="train").numpy()
           for f in frames]
    one = up(frames[0])
    assert isinstance(one, np.ndarray) and one.dtype == np.uint8
    assert np.array_equal(one, ref[0])
    dev = up(frames[1], fetch=False)
    assert isinstance(dev, torch.Tensor) and np.array_equal(dev.numpy(),
                                                            ref[1])
    b = up.batch(frames)
    assert b.shape == (3, 48, 64, 4)
    for i in range(3):
        assert np.array_equal(b[i], ref[i])
    for microbatch in ("auto", None, 2):
        out = list(up.stream(iter(frames), microbatch=microbatch))
        assert len(out) == 3
        for i in range(3):
            assert np.array_equal(out[i], ref[i])


def test_stream_keeps_order_across_shapes(up):
    a, b = _frames(2, 12, 16, seed=1), _frames(1, 8, 8, seed=2)
    seq = [a[0], b[0], a[1]]
    out = list(up.stream(iter(seq)))
    assert [o.shape for o in out] == [(48, 64, 4), (32, 32, 4), (48, 64, 4)]
    assert np.array_equal(out[1], up(b[0]))


def test_fetch_views_rgba32_words_as_hwc():
    rng = np.random.default_rng(3)
    hwc = rng.integers(0, 256, (5, 6, 4), dtype=np.uint8)
    words = torch.from_numpy(hwc.copy()).view(torch.uint32)[..., 0]
    assert np.array_equal(_fetch(words), hwc)
    assert np.array_equal(_fetch(torch.from_numpy(hwc)), hwc)


def test_start_fetch_views_a_cpu_result_as_it_is():
    rng = np.random.default_rng(4)
    hwc = rng.integers(0, 256, (5, 6, 4), dtype=np.uint8)
    words = torch.from_numpy(hwc.copy()).view(torch.uint32)[..., 0]
    batch = rng.integers(0, 256, (2, 5, 6, 3), dtype=np.uint8)
    for out, want in ((words, hwc), (torch.from_numpy(hwc), hwc),
                      (torch.from_numpy(batch), batch)):
        got = _start_fetch(out)()
        assert got.dtype == np.uint8 and np.array_equal(got, want)


def _drain_keeping(stream):
    """Every array ``stream`` yields, each checked unchanged whenever the
    generator has advanced past it."""
    kept, copies = [], []
    for arr in stream:
        for a, c in zip(kept, copies):
            assert np.array_equal(a, c)
        kept.append(arr)
        copies.append(np.array(arr, copy=True))
    for a, c in zip(kept, copies):
        assert np.array_equal(a, c)
    return kept


@pytest.mark.parametrize("kind", ["learned", "bicubic", "adaptive"])
@pytest.mark.parametrize("microbatch", ["auto", 2, None])
def test_stream_equals_calls_in_order_and_keeps_earlier_arrays(
        up, kind, microbatch):
    """``stream`` yields N x ``__call__``'s bytes in order, over shapes that
    break the groups, and an array it yielded stays as it was while the
    generator runs on (on the card each frame's copy is staged through
    pinned memory that later frames reuse)."""
    a, b = _frames(4, 12, 16, seed=5), _frames(2, 8, 8, seed=6)
    seq = [a[0], a[1], a[2], b[0], a[3], b[1]]
    server = up if kind == "learned" else Upscaler(
        scale=4, method=kind, device="cpu")
    got = _drain_keeping(server.stream(iter(seq), microbatch=microbatch))
    assert len(got) == len(seq)
    for frame, arr in zip(seq, got):
        assert arr.dtype == np.uint8
        assert np.array_equal(arr, server(frame))


def test_needs_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ModelUpscaler(str(CKPT))


def test_port_imports_nothing_of_jax():
    """Importing every module of the port, the port's bench script
    ``bench_torch.py``, its lab scripts ``scripts/torch_*_lab.py``, its
    measurement scripts ``scripts/torch_{bench_configs,latency_curve,
    method_throughput,launch_trace,span_split}.py`` and the card record's refresh and
    renderer ``scripts/torch_{refresh_results,render_readme_results}.py``
    leaves jax, flax, optax, msgpack and the JAX
    package out of sys.modules (names matched exactly: the port's own
    package shares the JAX package's prefix)."""
    labs = ["torch_kernel_lab", "torch_mxu_lab", "torch_packed_tail_lab",
            "torch_adaptive_lab", "torch_adaptive_probe_lab"]
    assert sorted(p.stem for p in (ROOT / "scripts").glob(
        "torch_*_lab.py")) == sorted(labs)
    measuring = ["torch_bench_configs", "torch_latency_curve",
                 "torch_method_throughput", "torch_launch_trace",
                 "torch_span_split", "torch_refresh_results", "torch_render_readme_results"]
    assert all((ROOT / "scripts" / f"{m}.py").exists() for m in measuring)
    mods = ["bench_torch", *labs, *measuring]
    for p in sorted((ROOT / "bicubic_interpolation_model_tpu_torch").rglob(
            "*.py")):
        parts = p.relative_to(ROOT).with_suffix("").parts
        mods.append(".".join(parts[:-1] if parts[-1] == "__init__"
                             else parts))
    code = (
        "import importlib, sys\n"
        "sys.path.insert(1, 'scripts')\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "banned = ('jax', 'flax', 'optax', 'msgpack', "
        "'bicubic_interpolation_model_tpu')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in banned)\n"
        "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    pkg = "bicubic_interpolation_model_tpu_torch."
    for name in ("core.kernels", "core.plan", "ops.resize", "ops.mxu",
                 "ops.phase", "ops.adaptive", "ops.adaptive_fused",
                 "ops.banded", "ops.downsample", "serving", "parallel.mesh",
                 "parallel.spatial", "parallel.batch",
                 "parallel.distributed", "models.espcn", "models.esrgan",
                 "models.srresnet_tpu", "models.mlp_predictor",
                 "models.tfjs_import", "evaluation.metrics",
                 "evaluation.compare", "data.binfmt", "utils.imageio",
                 "utils.config", "runtime.native", "data.div2k",
                 "data.onthefly", "data.validate", "train.trainer",
                 "train.direct_trainer", "train.mlp_trainer",
                 "parallel.train_sharding", "utils.profiling",
                 "core.oracle", "bench.harness", "bench.suite", "cli.main",
                 "cli.__main__", "bench.configs", "bench.methods"):
        assert pkg + name in mods
    assert len(mods) >= 55
