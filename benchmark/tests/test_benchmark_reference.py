"""The benchmark's plain references against the port's CPU path, and what
the benchmark's processes import. Run from the checkout's root:
``python -m pytest benchmark/tests``."""

from __future__ import annotations

import ast
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import correctness, spec, traffic  # noqa: E402
from benchmark.reference import bicubic, tf32_round  # noqa: E402
from benchmark.reference import weight_predictor as wp  # noqa: E402

SIZES = [(12, 20), (37, 19), (48, 64)]
LIMIT = 1e-3            # the configurations' mismatch_share


def frame(h, w, seed):
    return traffic.frame(traffic.rng_for(seed, 0), h, w, 4)


@pytest.mark.parametrize("h,w", SIZES)
def test_bicubic_reference_matches_port(h, w):
    from bicubic_interpolation_model_tpu_torch.serving import Upscaler
    img = frame(h, w, 5)
    got = Upscaler(scale=4, device="cpu")(img)
    want = bicubic.upscale(torch.as_tensor(img)).numpy()
    assert got.shape == want.shape == (4 * h, 4 * w, 4)
    assert np.abs(got.astype(int) - want).max() <= 1
    assert correctness.mismatch_share(got, want) <= LIMIT


@pytest.mark.parametrize("h,w", SIZES)
def test_weight_predictor_reference_matches_port(h, w):
    from bicubic_interpolation_model_tpu_torch.serving import ModelUpscaler
    cfg = spec.config("wp-1e-3-120")
    img = frame(h, w, 6)
    got = ModelUpscaler(str(ROOT / cfg["checkpoint"]), device="cpu")(img)
    state = wp.prepare(cfg, "cpu")
    want = wp.run(state, torch.as_tensor(img)).numpy()
    assert got.shape == want.shape == (4 * h, 4 * w, 4)
    assert np.abs(got.astype(int) - want).max() <= 1
    assert correctness.mismatch_share(got, want) <= LIMIT


def test_checkpoint_reader_reads_every_layer():
    p = wp.load(ROOT / spec.config("wp-1e-3-120")["checkpoint"], "cpu")
    shapes = {k: tuple(v["kernel"].shape) for k, v in p.items()}
    assert shapes == {"conv_in": (3, 3, 4, 32), "conv_res": (3, 3, 32, 32),
                      "upsample": (4, 4, 16, 32), "conv_att": (1, 1, 16, 1),
                      "conv_off": (1, 1, 2, 16),
                      "conv_out": (3, 3, 32, 16)}


def test_tf32_round_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, 1.0 + 2 ** -10,
                      255.0, -1.0 - 2 ** -12], dtype=torch.float32)
    got = tf32_round(x).tolist()
    # ties to even: 1 + 2^-11 -> 1, 1 + 3 * 2^-11 -> 1 + 2^-9
    assert got == [1.0, 1.0 + 2 ** -9, 1.0 + 2 ** -10, 255.0, -1.0]


def _top_level_imports(path: pathlib.Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize(
    "path", sorted((ROOT / "benchmark" / "reference").glob("*.py")),
    ids=lambda p: p.name)
def test_reference_sources_import_nothing_of_the_program(path):
    assert not _top_level_imports(path) & {
        "bicubic_interpolation_model_tpu_torch",
        "bicubic_interpolation_model_tpu", "jax", "jaxlib", "flax",
        "benchmark"}


_REFERENCE_ONLY = """
import json, sys, torch
sys.path.insert(0, {root!r})
from benchmark.reference import bicubic, weight_predictor as wp
from benchmark import spec
img = torch.randint(0, 256, (9, 11, 4), dtype=torch.uint8)
bicubic.upscale(img)
wp.run(wp.prepare(spec.config("wp-1e-3-120"), "cpu"), img)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_reference_runs_without_loading_the_program():
    out = subprocess.run(
        [sys.executable, "-c", _REFERENCE_ONLY.format(root=str(ROOT))],
        capture_output=True, text=True, check=True, cwd=ROOT)
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not loaded & {"bicubic_interpolation_model_tpu_torch",
                         "bicubic_interpolation_model_tpu", "jax", "jaxlib",
                         "flax"}


_RUN = """
import json, sys, time
sys.path.insert(0, {root!r})
from benchmark import harness
small = {{"frame": [10, 14, 4], "pool": 2, "warmup_frames": 2, "sample": 2}}
for cell in ("wp_div2k_call", "bicubic_1080p_call"):
    harness.run_cell(cell, 7, 0.2, False, time.perf_counter(), device="cpu",
                     mix_override=small, log=lambda s: None)
for name in ("frames_per_s", "model_mfu.call", "tail_roofline.stream"):
    harness.spec.reader(name)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_a_run_loads_no_jax_by_whole_top_level_name():
    """The port's name begins with the JAX package's, so names are
    compared whole: the port is loaded, the JAX package is not."""
    out = subprocess.run([sys.executable, "-c", _RUN.format(root=str(ROOT))],
                         capture_output=True, text=True, check=True,
                         cwd=ROOT)
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "bicubic_interpolation_model_tpu_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax",
                         "bicubic_interpolation_model_tpu"}
