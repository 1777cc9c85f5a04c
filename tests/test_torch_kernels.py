"""The CUDA kernels of the port (csrc/packed_tail.cu, csrc/interleave.cu)
against their plain PyTorch versions, and the wrapper contract around them.

This file imports nothing of JAX, so it also runs on a machine with a card
and no JAX: ``python -m pytest --noconftest -m cuda tests/test_torch_kernels.py``.
Tests marked ``cuda`` skip without a card (a CUDA kernel has no CPU mode).

Tolerances on the card, kernel vs plain version: kernel A ≤1 u8 LSB with a
share of differing bytes < 1e-3 at f32 and with opaque alpha, ≤2 LSB with
bf16 features (sums in another order); kernel B bit-equal (a copy)."""

import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from bicubic_interpolation_model_tpu_torch.models.inference import (
    _tail_operands)
from bicubic_interpolation_model_tpu_torch.ops import interleave as ilv
from bicubic_interpolation_model_tpu_torch.ops import packed_tail as pt

ROOT = pathlib.Path(__file__).resolve().parents[1]
GEOMETRIES = [(24, 40, 4), (19, 37, 4), (13, 9, 3), (8, 128, 1),
              (348, 510, 4)]


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _tail_args(h, w, c, seed, device="cpu", opaque=False):
    """Random tail inputs made by numpy from a seed."""
    rng = np.random.default_rng(seed)
    n = lambda *s: torch.as_tensor(rng.normal(0, 0.25, s).astype(np.float32),
                                   device=device)
    p = {"upsample": {"kernel": n(4, 4, 16, 32), "bias": n(16)},
         "conv_att": {"kernel": n(1, 1, 16, 1), "bias": n(1)},
         "conv_off": {"kernel": n(1, 1, 2, 16), "bias": n(16)},
         "conv_out": {"kernel": n(3, 3, 32, 16) * 0.4, "bias": n(16)}}
    y = torch.as_tensor(rng.normal(0, 0.5, (h, w, 32)).astype(np.float32),
                        device=device)
    lr = rng.integers(0, 256, (h, w, c)).astype(np.float32)
    if opaque:
        lr[..., 3] = 255.0
    return (y, torch.as_tensor(lr, device=device), p["conv_out"]["kernel"],
            p["conv_out"]["bias"], *_tail_operands(p, 4, "train"))


def _diff(a, b):
    d = (a.view(torch.uint8).long() - b.view(torch.uint8).long()).abs()
    return int(d.max()), float((d != 0).double().mean())


def test_cpu_tensors_take_the_plain_versions_and_launch_nothing():
    args = _tail_args(8, 12, 4, seed=0)
    a0, b0 = pt.packed_tail_fused.launches, ilv.interleave_planar_u32.launches
    planar = pt.packed_tail_fused(*args, layout="planar")
    ref = pt.packed_tail_fused_reference(args[0][None], args[1][None],
                                         *args[2:])[0]
    assert torch.equal(planar.view(torch.int32), ref.view(torch.int32))
    words = ilv.interleave_planar_u32(planar)
    assert torch.equal(words.view(torch.int32),
                       ilv.interleave_planar_u32_reference(planar)
                       .contiguous().view(torch.int32))
    assert (pt.packed_tail_fused.launches,
            ilv.interleave_planar_u32.launches) == (a0, b0)


def test_importing_the_port_builds_nothing():
    """Importing every kernel module neither runs nvcc nor loads a
    library: the build happens at the first launch on a card."""
    code = ("from bicubic_interpolation_model_tpu_torch.ops import "
            "packed_tail, interleave\n"
            "from bicubic_interpolation_model_tpu_torch.runtime import build\n"
            "assert build._lib is None\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_kernel_sources_are_listed():
    from bicubic_interpolation_model_tpu_torch.runtime import build
    names = [p.name for p in build.sources()]
    assert names == ["interleave.cu", "packed_tail.cu"]
    for name in names:
        text = (build.CSRC / name).read_text()
        assert "Replaces:" in text and "extern \"C\"" in text


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,c", GEOMETRIES)
def test_kernel_a_matches_plain_on_card(cuda, h, w, c):
    args = _tail_args(h, w, c, seed=h + w, device=cuda)
    before = pt.packed_tail_fused.launches
    got = pt.packed_tail_fused(*args, layout="planar")
    assert pt.packed_tail_fused.launches == before + 1
    ref = pt.packed_tail_fused_reference(args[0][None], args[1][None],
                                         *args[2:])[0]
    mx, share = _diff(got, ref)
    assert mx <= 1 and share < 1e-3
    assert float(got.view(torch.uint8).float().std()) > 0
    bf = (args[0].to(torch.bfloat16),) + args[1:]
    gb = pt.packed_tail_fused(*bf, layout="planar")
    rb = pt.packed_tail_fused_reference(bf[0][None], bf[1][None], *bf[2:])[0]
    assert _diff(gb, rb)[0] <= 2


@pytest.mark.cuda
def test_kernel_a_opaque_alpha_and_batch_on_card(cuda):
    args = _tail_args(21, 45, 4, seed=11, device=cuda, opaque=True)
    got = pt.packed_tail_fused(*args, layout="planar", opaque_alpha=True)
    ref = pt.packed_tail_fused_reference(args[0][None], args[1][None],
                                         *args[2:], opaque_alpha=True)[0]
    assert _diff(got, ref)[0] <= 1
    two = pt.packed_tail_fused(torch.stack([args[0], args[0].flip(0)]),
                               torch.stack([args[1], args[1].flip(0)]),
                               *args[2:], layout="planar")
    assert torch.equal(two[0].view(torch.int32),
                       pt.packed_tail_fused(*args, layout="planar")
                       .view(torch.int32))
    one = pt.packed_tail_fused(args[0].flip(0).contiguous(),
                               args[1].flip(0).contiguous(), *args[2:],
                               layout="planar")
    assert torch.equal(two[1].view(torch.int32), one.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 1392, 510), (3, 37, 53), (1, 5, 7)])
def test_kernel_b_matches_plain_on_card(cuda, shape):
    rng = np.random.default_rng(0)
    planar = torch.from_numpy(
        rng.integers(0, 2 ** 32, shape, dtype=np.uint32)).to(cuda)
    before = ilv.interleave_planar_u32.launches
    got = ilv.interleave_planar_u32(planar)
    assert ilv.interleave_planar_u32.launches == before + 1
    ref = ilv.interleave_planar_u32_reference(planar).contiguous()
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))


@pytest.mark.cuda
def test_kernels_refuse_non_contiguous_input(cuda):
    planar = torch.zeros((4, 8, 16), dtype=torch.uint32, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        ilv.interleave_planar_u32(planar[:, :, ::2])
