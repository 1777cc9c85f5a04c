"""The seven CUDA kernels of the port (csrc/packed_tail.cu,
csrc/packed_tail_map.cu, csrc/interleave.cu, csrc/resize_mxu.cu,
csrc/resize_phase.cu, csrc/adaptive.cu, csrc/resize_banded.cu) against their
plain PyTorch versions, the wrapper contract around them, and the sharded
paths (parallel/) on a mesh that repeats the card.

This file imports nothing of JAX, so it also runs on a machine with a card
and no JAX: ``python -m pytest --noconftest -m cuda tests/test_torch_kernels.py``.
Tests marked ``cuda`` skip without a card (a CUDA kernel has no CPU mode).

Tolerances on the card, kernel vs plain version: kernel A ≤1 u8 LSB with a
share of differing bytes < 1e-3 at f32 and with opaque alpha, ≤2 LSB with
bf16 features (sums in another order); kernel G the same as A, on both
halos; kernel B bit-equal (a copy);
kernels C and D ≤1 u8 LSB from their plain versions at f32 (nvcc contracts
a*b+c to FMA, PyTorch does not; kernel C sums each output's taps in input
order from its bands) with a share of differing bytes < 1e-3, and ≤1 LSB
from the plain versions at float64; ``nearest`` bit-equal; float inputs
within 1e-3 absolute on a 0-255 range; kernel F the same as C and D; kernel
E (1 to 4 channels) ≤1 u8 LSB from its plain version at f32 and float64
with a share of differing bytes < 1e-3 (its sums factored per centre variant, FMA
contraction, approximate ``ex2`` and reciprocal against ``torch.exp`` and a
division) and the same region class at every pixel (its variance stage is
written without contraction in the plain version's order of summation).
``stream`` on the card yields ``__call__``'s bytes. Sharded paths on
the card: classical, adaptive and batch bands byte-equal to the
single-frame kernels (each band runs them on the same weights), learned
bands ≤1 LSB from the sharded graph tail and ≤2 from the single-frame
``super_resolve`` (kernel A). Direct-regression checkpoints served by
``ModelUpscaler`` on the card (cuDNN convs, TF32 off): ≤1 u8 from the same
model run in float64 on the card with a share < 1e-3, ``batch`` within ±1
of per-frame calls. The bench (bench/): the harness's fenced wall time of
a CUDA workload at least 0.9 of its CUDA-event time (the two clocks
differ by the events' own resolution); ``check_parity`` of kernels C, D,
D planar and F at 1080x1920 RGBA -> 4x ≤1 u8 from the port's float64
oracle. The probe instances of D, E and G (bench/labs.py) against their
plain versions at the labs' tolerances, and the production instances of
all seven kernels byte-equal (sha256) to what they gave before the probes
were added."""

import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from bicubic_interpolation_model_tpu_torch.bench.labs import all_class_frames
from bicubic_interpolation_model_tpu_torch.models.inference import (
    _tail_operands)
from bicubic_interpolation_model_tpu_torch.ops import adaptive_fused as adf
from bicubic_interpolation_model_tpu_torch.ops import banded
from bicubic_interpolation_model_tpu_torch.ops import interleave as ilv
from bicubic_interpolation_model_tpu_torch.ops import mxu, phase
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


def _map_args(h, w, c, halo, seed, device="cpu", opaque=False):
    """A random merged map [h(+2), w, 4, 4, 32], LR pixels [h(+3), w, c]
    and conv_out made by numpy from a seed (kernel G's operands)."""
    rng = np.random.default_rng(seed)
    rows, lr_rows = (h + 2, h + 3) if halo == "rows" else (h, h)
    t = lambda a: torch.as_tensor(a.astype(np.float32), device=device)
    lr = rng.integers(0, 256, (lr_rows, w, c))
    if opaque:
        lr[..., 3] = 255
    return (t(rng.normal(0, 0.5, (rows, w, 4, 4, 32))), t(lr),
            t(rng.normal(0, 0.05, (3, 3, 32, 16))),
            t(rng.normal(0, 0.25, 16)))


def _diff(a, b):
    d = (a.view(torch.uint8).long() - b.view(torch.uint8).long()).abs()
    return int(d.max()), float((d != 0).double().mean())


def _frames(seed, b, h, w, c, device="cpu"):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        rng.integers(0, 256, (b, h, w, c), dtype=np.uint8)).to(device)


def test_cpu_tensors_take_the_plain_versions_and_launch_nothing():
    args = _tail_args(8, 12, 4, seed=0)
    a0, b0 = pt.packed_tail_fused.launches, ilv.interleave_planar_u32.launches
    c0, d0 = mxu.resize_mxu.launches, phase.resize_phase.launches
    img = _frames(1, 2, 9, 7, 3)
    cache = {}
    got = mxu.resize_mxu(img, 2.5, "bicubic", weight_cache=cache)
    ops = next(iter(cache.values()))
    assert torch.equal(got, mxu.resize_mxu_reference(img, *ops[:4]))
    cache = {}
    got = phase.resize_phase(img, 3, "lanczos", weight_cache=cache)
    wrow, wcol, taps, left = next(iter(cache.values()))[:4]
    assert torch.equal(got, phase.resize_phase_reference(img, wrow, wcol, 3,
                                                         taps, left))
    assert (mxu.resize_mxu.launches, phase.resize_phase.launches) == (c0, d0)
    e0, f0 = adf.adaptive_resize_fused.launches, banded.resize_banded.launches
    cache = {}
    got = adf.adaptive_resize_fused(img[..., :3], 2, weight_cache=cache)
    assert torch.equal(got, adf.adaptive_resize_reference(
        img[..., :3], *next(iter(cache.values())), 2))
    cache = {}
    got = banded.resize_banded(img, 3, "lanczos", weight_cache=cache)
    assert torch.equal(got, banded.resize_banded_reference(
        img, *next(iter(cache.values()))[:2], 3, 2))
    assert (adf.adaptive_resize_fused.launches,
            banded.resize_banded.launches) == (e0, f0)
    planar = pt.packed_tail_fused(*args, layout="planar")
    ref = pt.packed_tail_fused_reference(args[0][None], args[1][None],
                                         *args[2:])[0]
    assert torch.equal(planar.view(torch.int32), ref.view(torch.int32))
    g0 = pt.packed_tail.launches
    m, lr, kout, bout = _map_args(6, 10, 3, "rows", seed=0)
    got = pt.packed_tail(m, lr, kout, bout, layout="planar", halo="rows")
    assert torch.equal(got.view(torch.int32), pt.packed_tail_reference(
        m, lr, kout, bout, halo="rows").view(torch.int32))
    assert pt.packed_tail.launches == g0
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
            "packed_tail, interleave, mxu, phase, resize, adaptive, "
            "adaptive_fused, banded, downsample\n"
            "from bicubic_interpolation_model_tpu_torch.parallel import "
            "mesh, spatial, batch, distributed\n"
            "from bicubic_interpolation_model_tpu_torch.runtime import build\n"
            "assert build._lib is None\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_kernel_sources_are_listed():
    from bicubic_interpolation_model_tpu_torch.runtime import build
    names = [p.name for p in build.sources()]
    assert names == ["adaptive.cu", "interleave.cu", "packed_tail.cu",
                     "packed_tail_map.cu", "resize_banded.cu",
                     "resize_mxu.cu", "resize_phase.cu"]
    for name in names:
        text = (build.CSRC / name).read_text()
        assert "Replaces:" in text and "extern \"C\"" in text
    entry_points = " ".join((build.CSRC / n).read_text() for n in names)
    for symbol in build._SIGNATURES:
        assert f"int {symbol}(" in entry_points
    assert len(build._SIGNATURES) == 7


def test_tail_kernels_share_the_tensor_core_header():
    """Kernels A and G contract conv_out (and A its upsample) through one
    MMA core: 3xTF32 (split by masks) on the f32 route, one bf16 pass on
    the bf16 route; the header is part of the build's source hash."""
    from bicubic_interpolation_model_tpu_torch.runtime import build
    header = (build.CSRC / "tail_mma.cuh").read_text()
    for ptx in ("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32",
                "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32",
                "TF32_MASK", "cp.async.cg.shared.global"):
        assert ptx in header
    for name in ("packed_tail.cu", "packed_tail_map.cu"):
        text = (build.CSRC / name).read_text()
        assert '#include "tail_mma.cuh"' in text
        assert "mma_chunk" in text and "cp_async16" in text
    assert "tail_mma.cuh" in [p.name for p in build.CSRC.glob("*.cu*")]


# mangled names of the seven kernel templates, with and without the last
# probe argument of D, E and G: as nvcc names them in the anonymous
# namespace of csrc/*.cu (cuobjdump listings of the built library, with the
# probe argument, and of its previous revision, without), and as g++ names
# the same templates outside any namespace
_NV = "_ZN{}_GLOBAL__N__{}_cu_{}"
MANGLED = [
    (_NV.format(44, "4396e625_11_adaptive", "0811eedf15adaptive_kernel")
     + "ILi1ELb0ELb0ELi5EEEvPKhPKfS4_S4_PhS5_iiiiii",
     "adaptive_kernel<1,0,0,5>"),
    (_NV.format(44, "4396e625_11_adaptive", "0811eedf15adaptive_kernel")
     + "ILi4ELb1ELb0ELi0EEEvPKhPKfS4_S4_PhS5_iiiiii",
     "adaptive_kernel<4,1,0,0>"),
    (_NV.format(46, "9b52cb11_13_interleave", "9eda1a0317interleave_kernel")
     + "ILi0EEEvPKjPjiii", "interleave_kernel<0>"),
    (_NV.format(46, "9b52cb11_13_interleave", "9eda1a0317interleave_kernel")
     + "ILi4EEEvPKjPjiii", "interleave_kernel<4>"),
    (_NV.format(51, "0296182d_18_packed_tail_map",
                "dd63745722packed_tail_map_kernel")
     + "ILb0EfLi3EEEvPKT0_PKfS5_S5_Pjiiiiii",
     "packed_tail_map_kernel<0,float,3>"),
    (_NV.format(51, "0296182d_18_packed_tail_map",
                "dd63745722packed_tail_map_kernel")
     + "ILb1E13__nv_bfloat16Li0EEEvPKT0_PKfS6_S6_Pjiiiiii",
     "packed_tail_map_kernel<1,bf16,0>"),
    (_NV.format(49, "089fbe9f_16_resize_banded",
                "6acf633f20resize_banded_kernel")
     + "ILi4ELb1EEEvPKNS_4ElemIXT0_EE4typeEPKfS7_PK4int2SA_PS3_NS_8GeometryE",
     "resize_banded_kernel<4,1>"),
    (_NV.format(46, "ba66e9c1_13_resize_mxu", "5fef4faa18resize_plan_kernel")
     + "ILi1ELb1EEEvPKNS_4ElemIXT0_EE4typeEPKfPKiS9_S7_S9_S9_PS3_NS_8GeometryE",
     "resize_plan_kernel<1,1>"),
    (_NV.format(48, "b977c4d3_15_resize_phase",
                "19def59019resize_phase_kernel")
     + "ILi4ELb1ELb0ELi3EEEvPKNS_4ElemIXT0_EE4typeEPKfS7_PS3_NS_8GeometryE",
     "resize_phase_kernel<4,1,0,3>"),
    (_NV.format(48, "b977c4d3_15_resize_phase",
                "19def59019resize_phase_kernel")
     + "ILi1ELb1ELb1ELi0EEEvPKNS_4ElemIXT0_EE4typeEPKfS7_PS3_NS_8GeometryE",
     "resize_phase_kernel<1,1,1,0>"),
    ("_ZN47_GLOBAL__N__8c8101ee_14_packed_tail_cu_1bf3c40924packed_tail_"
     "fused_kernelILb0EfEEvPKT0_PKfS5_S5_S5_S5_S5_S5_S5_Pjiiii",
     "packed_tail_fused_kernel<0,float>"),
    ("_ZN47_GLOBAL__N__8c8101ee_14_packed_tail_cu_1bf3c40924packed_tail_"
     "fused_kernelILb1E13__nv_bfloat16EEvPKT0_PKfS6_S6_S6_S6_S6_S6_S6_"
     "Pjiiii", "packed_tail_fused_kernel<1,bf16>"),
    ("_ZN51_GLOBAL__N__0296182d_18_packed_tail_map_cu_dd63745722packed_"
     "tail_map_kernelILb0EfEEvPKT0_PKfS5_S5_Pjiiiiii",
     "packed_tail_map_kernel<0,float>"),
    ("_ZN51_GLOBAL__N__0296182d_18_packed_tail_map_cu_dd63745722packed_"
     "tail_map_kernelILb1E13__nv_bfloat16EEvPKT0_PKfS6_S6_Pjiiiiii",
     "packed_tail_map_kernel<1,bf16>"),
    ("_Z24packed_tail_fused_kernelILb0EfEvPKT0_PKfPji",
     "packed_tail_fused_kernel<0,float>"),
    ("_Z24packed_tail_fused_kernelILb1E13__nv_bfloat16EvPKT0_PKfPji",
     "packed_tail_fused_kernel<1,bf16>"),
    ("_Z22packed_tail_map_kernelILb0EfLi0EEvPKT0_PKfPji",
     "packed_tail_map_kernel<0,float,0>"),
    ("_Z22packed_tail_map_kernelILb1E13__nv_bfloat16Li3EEvPKT0_PKfPji",
     "packed_tail_map_kernel<1,bf16,3>"),
    ("_Z15adaptive_kernelILi4ELb0ELb0ELi5EEvPKhPhi",
     "adaptive_kernel<4,0,0,5>"),
    ("_Z15adaptive_kernelILi1ELb1ELb1ELi0EEvPKhPhi",
     "adaptive_kernel<1,1,1,0>"),
    ("_Z15adaptive_kernelILi4ELb0ELb0EEvPKhPhi", "adaptive_kernel<4,0,0>"),
    ("_Z19resize_phase_kernelILi4ELb1ELb1EEvPKvi",
     "resize_phase_kernel<4,1,1>"),
    ("_Z17interleave_kernelILi4EEvPKjPji", "interleave_kernel<4>"),
    ("_Z17interleave_kernelILin1EEvPKjPji", "interleave_kernel<-1>"),
    ("_Z18resize_plan_kernelILi3ELb0EEvPKvi", "resize_plan_kernel<3,0>"),
    ("_Z19resize_phase_kernelILi4ELb1ELb0ELi0EEvPKvi",
     "resize_phase_kernel<4,1,0,0>"),
    ("_Z19resize_phase_kernelILi4ELb1ELb1ELi2EEvPKvi",
     "resize_phase_kernel<4,1,1,2>"),
    ("_Z20resize_banded_kernelILi4ELb1EEvPKvi", "resize_banded_kernel<4,1>"),
    ("bim_resize_phase", "bim_resize_phase"),
    ("_Z15adaptive_kernelILi4", "_Z15adaptive_kernelILi4"),
]


@pytest.mark.parametrize("mangled,name", MANGLED)
def test_kernel_instance_reads_every_template_argument(mangled, name):
    """The build line and the SASS comparison name an instance by all of
    its template arguments, the last one too, nested or not; a name that
    is no templated kernel, or is cut short, stays as it is."""
    from bicubic_interpolation_model_tpu_torch.runtime import build
    assert build.kernel_instance(mangled) == name


def test_ptxas_summary_names_each_instance():
    from bicubic_interpolation_model_tpu_torch.runtime import build
    fused = next(m for m, name in MANGLED
                 if name == "packed_tail_fused_kernel<0,float>")
    log = "\n".join([
        "ptxas info    : Compiling entry function '" + fused
        + "' for 'sm_90a'",
        "ptxas info    : Function properties for " + fused,
        "    64 bytes stack frame, 60 bytes spill stores, 60 bytes spill "
        "loads",
        "ptxas info    : Used 128 registers, used 1 barriers, 64 bytes "
        "cumulative stack size",
        "ptxas info    : Compiling entry function '_Z15adaptive_kernelILi4"
        "ELb0ELb0ELi5EEvPKhPhi' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 79 registers, used 1 barriers"])
    assert build.ptxas_summary(log) == [
        "packed_tail_fused_kernel<0,float>: 128 registers, used 1 barriers,"
        " 64 bytes cumulative stack size; 64 bytes stack frame, 60 bytes "
        "spill stores, 60 bytes spill loads",
        "adaptive_kernel<4,0,0,5>: 79 registers, used 1 barriers; 0 bytes "
        "stack frame, 0 bytes spill stores, 0 bytes spill loads"]


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


# frames ragged for the kernels' 16-row (pixel) and 8-column (weight) MMA
# tiles: a tile row shorter than 16 pixels, a single pixel, 130 columns
MMA_EDGES = [(17, 23, 4), (1, 1, 3), (2, 130, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,c", MMA_EDGES)
def test_kernel_a_mma_tile_edges_on_card(cuda, h, w, c):
    """Pixels past the frame's edge feed zeros to the map and store
    nothing: f32, bf16, opaque alpha and a batch of 3 against the plain
    version."""
    args = _tail_args(h, w, c, seed=3 * h + w, device=cuda, opaque=c == 4)
    rng = np.random.default_rng(h * w)
    y3 = torch.as_tensor(rng.normal(0, 0.5, (3, h, w, 32)).astype(
        np.float32), device=cuda)
    lr3 = torch.as_tensor(rng.integers(0, 256, (3, h, w, c)).astype(
        np.float32), device=cuda)
    for y, lr in ((args[0][None], args[1][None]), (y3, lr3)):
        for yy in (y, y.to(torch.bfloat16)):
            got = pt.packed_tail_fused(yy, lr, *args[2:], layout="planar")
            ref = pt.packed_tail_fused_reference(yy, lr, *args[2:])
            assert got.shape == (y.shape[0], 4, 4 * h, w)
            mx, share = _diff(got, ref)
            if yy.dtype == torch.float32:
                assert mx <= 1 and share < 1e-3
            else:
                assert mx <= 2
    if c == 4:
        y, lr = args[0][None], args[1][None]
        got = pt.packed_tail_fused(y, lr, *args[2:], layout="planar",
                                   opaque_alpha=True)
        ref = pt.packed_tail_fused_reference(y, lr, *args[2:],
                                             opaque_alpha=True)
        assert _diff(got, ref)[0] <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,c,halo", [g + ("zero",) for g in MMA_EDGES]
                         + [(1, 23, 4, "rows"), (3, 130, 2, "rows"),
                            (1, 1, 3, "rows")])
def test_kernel_g_mma_tile_edges_on_card(cuda, h, w, c, halo):
    """Kernel G at frames and bands of 1 and 3 rows that are ragged for
    its MMA tiles: f32, bf16 maps and opaque alpha against the plain
    version."""
    args = _map_args(h, w, c, halo, seed=5 * h + w, device=cuda,
                     opaque=c == 4)
    got = pt.packed_tail(*args, layout="planar", halo=halo)
    assert got.shape == (4, 4 * h, w)
    mx, share = _diff(got, pt.packed_tail_reference(*args, halo=halo))
    assert mx <= 1 and share < 1e-3
    bf = (args[0].to(torch.bfloat16),) + args[1:]
    gb = pt.packed_tail(*bf, layout="planar", halo=halo)
    assert _diff(gb, pt.packed_tail_reference(*bf, halo=halo))[0] <= 2
    if c == 4:
        got = pt.packed_tail(*args, layout="planar", halo=halo,
                             opaque_alpha=True)
        ref = pt.packed_tail_reference(*args, halo=halo, opaque_alpha=True)
        assert _diff(got, ref)[0] <= 1


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


def _diff_u8(a, b):
    d = (a.long() - b.long()).abs()
    return int(d.max()), float((d != 0).double().mean())


METHODS = ["nearest", "bilinear", "bicubic", "lanczos"]


@pytest.mark.cuda
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("scale,h,w", [
    (4, 23, 37), (2, 23, 37), (3, 13, 9), (1.5, 40, 64), (2.5, 40, 64),
    (1.25, 40, 64), (1, 13, 9)])
def test_kernel_c_matches_plain_on_card(cuda, method, scale, h, w):
    for c in (1, 2, 3, 4):
        img = _frames(h + c, 2, h, w, c, cuda)
        cache = {}
        before = mxu.resize_mxu.launches
        got = mxu.resize_mxu(img, scale, method, weight_cache=cache)
        assert mxu.resize_mxu.launches == before + 1
        ops = next(iter(cache.values()))
        mx, share = _diff_u8(got, mxu.resize_mxu_reference(img, *ops[:4]))
        assert mx <= 1 and share < 1e-3
        assert mx == 0 or method != "nearest"
        assert _diff_u8(got, mxu.resize_mxu_reference(
            img, *ops[:4], dtype=torch.float64))[0] <= 1
        assert float(got.float().std()) > 0
        assert torch.equal(got[1], mxu.resize_mxu(img[1], scale, method))
        gf = mxu.resize_mxu(img.float(), scale, method)
        rf = mxu.resize_mxu_reference(img.float(), *ops[:4])
        assert gf.dtype == torch.float32
        assert float((gf - rf).abs().max()) < 1e-3


@pytest.mark.cuda
def test_kernel_c_flat_layout_and_full_frame_on_card(cuda):
    img = _frames(0, 1, 1080, 1920, 4, cuda)
    cache = {}
    flat = mxu.resize_mxu(img, 4, "bicubic", layout="flat",
                          weight_cache=cache)
    assert flat.shape == (1, 4320, 7680 * 4)
    ops = next(iter(cache.values()))
    ref = mxu.resize_mxu_reference(img, *ops[:4], dtype=torch.float64)
    view = mxu.flat_to_hwc_np(flat[0, :64].cpu().numpy(), 64, 7680, 4)
    np.testing.assert_array_equal(
        view, mxu.resize_mxu(img, 4, "bicubic")[0, :64].cpu().numpy())
    mx, share = _diff_u8(flat.reshape(ref.shape), ref)
    assert mx <= 1 and share < 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("s", [1, 2, 3, 4])
def test_kernel_d_matches_plain_on_card(cuda, method, s):
    for h, w, c in [(23, 37, 4), (40, 64, 3), (13, 9, 1), (7, 5, 2)]:
        img = _frames(h + s, 2, h, w, c, cuda)
        cache = {}
        before = phase.resize_phase.launches
        got = phase.resize_phase(img, s, method, weight_cache=cache)
        assert phase.resize_phase.launches == before + 1
        wrow, wcol, taps, left = next(iter(cache.values()))[:4]
        ref = phase.resize_phase_reference(img, wrow, wcol, s, taps, left)
        mx, share = _diff_u8(got, ref)
        assert mx <= 1 and share < 1e-3
        assert mx == 0 or method != "nearest"
        assert _diff_u8(got, phase.resize_phase_reference(
            img, wrow, wcol, s, taps, left, dtype=torch.float64))[0] <= 1
        planar = phase.resize_phase(img, s, method, layout="planar")
        assert planar.shape == (2, s, h * s, w * c)
        assert torch.equal(phase.interleave_planar(planar, h, w, s, c), got)
        assert torch.equal(got[1], phase.resize_phase(img[1], s, method))
        assert _diff_u8(got, mxu.resize_mxu(img, s, method))[0] <= 1
        gf = phase.resize_phase(img.float(), s, method)
        rf = phase.resize_phase_reference(img.float(), wrow, wcol, s, taps,
                                          left)
        assert float((gf - rf).abs().max()) < 1e-3


@pytest.mark.cuda
def test_kernel_d_lanczos_window_and_full_frame_on_card(cuda):
    img = _frames(3, 1, 20, 16, 4, cuda)
    a2 = phase.resize_phase(img, 4, "lanczos", lanczos_a=2)
    wrow, wcol, taps, left = phase._weights("lanczos", 20, 16, 4, -0.5, 2,
                                            cuda, None)[:4]
    assert taps == 4 and _diff_u8(a2, phase.resize_phase_reference(
        img, wrow, wcol, 4, taps, left))[0] <= 1
    big = _frames(4, 1, 1080, 1920, 4, cuda)
    got = phase.resize_phase(big, 4, "bicubic")
    mx, share = _diff_u8(got, mxu.resize_mxu(big, 4, "bicubic"))
    assert got.shape == (1, 4320, 7680, 4) and mx <= 1 and share < 1e-3


@pytest.mark.cuda
def test_resize_and_upscaler_route_to_the_kernels_on_card(cuda):
    from bicubic_interpolation_model_tpu_torch.ops.resize import resize
    from bicubic_interpolation_model_tpu_torch.serving import Upscaler
    img = _frames(5, 1, 24, 20, 4)[0].numpy()
    c0, d0 = mxu.resize_mxu.launches, phase.resize_phase.launches
    out = resize(img, 4)
    assert out.is_cuda and mxu.resize_mxu.launches == c0 + 1
    assert _diff_u8(out, resize(img, 4, impl="gather"))[0] <= 1
    # a 1-channel frame at 17/16 is outside the JAX tiler's set and inside
    # kernel C's: it takes the kernel, not the plain graph
    gray = resize(img[..., 0], 17 / 16)
    assert not mxu.mxu_supported(17 / 16, 1)
    assert gray.shape == (26, 21) and mxu.resize_mxu.launches == c0 + 2
    assert _diff_u8(gray, resize(img[..., 0], 17 / 16,
                                 impl="gather"))[0] <= 1
    # numpy frames handed to the wrappers themselves go to the card
    assert mxu.resize_mxu(img, 2).is_cuda and phase.resize_phase(img, 2).is_cuda
    assert (mxu.resize_mxu.launches, phase.resize_phase.launches) == (
        c0 + 3, d0 + 1)
    c0, d0 = c0 + 3, d0 + 1
    # what no kernel takes goes to the plain graph: 5 channels, a scale
    # with no small rational form
    five = np.concatenate([img, img[..., :1]], axis=-1)
    assert resize(five, 4).shape == (96, 80, 5)
    assert resize(img, 2 ** 0.5).shape == (34, 28, 4)
    wide = Upscaler(scale=4)
    b5 = wide.batch(np.stack([five, five]))
    assert b5.shape == (2, 96, 80, 5)
    np.testing.assert_array_equal(b5[0], wide(five))
    np.testing.assert_array_equal(list(wide.stream([five, five]))[1], b5[1])
    assert (mxu.resize_mxu.launches, phase.resize_phase.launches) == (c0, d0)
    # float batches take the same kernel as float frames
    fb = wide.batch(np.stack([img, img]).astype(np.float32), fetch=False)
    assert fb.dtype == torch.float32 and mxu.resize_mxu.launches == c0 + 1
    assert torch.equal(fb[0], wide(img.astype(np.float32), fetch=False))
    assert Upscaler(scale=4, bucket=16)(img).shape == (96, 80, 4)
    c0 = mxu.resize_mxu.launches
    assert resize(img, 3, impl="pallas_phase").shape == (72, 60, 4)
    assert phase.resize_phase.launches == d0 + 1
    up = Upscaler(scale=2.5)
    host = up(img)
    assert isinstance(host, np.ndarray) and host.shape == (60, 50, 4)
    assert mxu.resize_mxu.launches == c0 + 1
    assert _diff_u8(torch.from_numpy(host).to(cuda),
                    resize(img, 2.5, impl="gather"))[0] <= 1
    outs = list(Upscaler(scale=4, impl="pallas_phase").stream([img, img]))
    assert phase.resize_phase.launches == d0 + 2   # one grouped launch
    assert _diff_u8(torch.from_numpy(outs[1]).to(cuda), out)[0] <= 1


def _all_class_frames(seed, b, h, w, c, device="cpu"):
    """Frames that reach all three region classes of adaptive bicubic and
    both thresholds, from a seed."""
    return torch.from_numpy(all_class_frames(
        np.random.default_rng(seed), b, h, w, c)).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 2, 3, 4])
@pytest.mark.parametrize("h,w,c", [(13, 11, 4), (8, 40, 3), (24, 70, 4),
                                   (37, 33, 3)])
def test_kernel_e_matches_plain_on_card(cuda, s, h, w, c):
    from bicubic_interpolation_model_tpu_torch.ops.adaptive import (
        luma_bt709, region_classes)
    img = _all_class_frames(h + s, 3, h, w, c, cuda)
    cache = {}
    cls = torch.empty((3, h, w), dtype=torch.uint8, device=cuda)
    before = adf.adaptive_resize_fused.launches
    got = adf.adaptive_resize_fused(img, s, weight_cache=cache,
                                    classes_out=cls)
    assert adf.adaptive_resize_fused.launches == before + 1
    assert got.shape == (3, h * s, w * s, c) and got.dtype == torch.uint8
    wts = next(iter(cache.values()))
    want_cls = region_classes(luma_bt709(img.float()))
    assert torch.equal(cls, want_cls)
    assert len(torch.unique(cls)) == 3 or h * w < 1000
    mx, share = _diff_u8(got, adf.adaptive_resize_reference(img, *wts, s))
    assert mx <= 1 and share < 1e-3
    mx64, share64 = _diff_u8(got, adf.adaptive_resize_reference(
        img, *wts, s, dtype=torch.float64))
    assert mx64 <= 1 and share64 < 1e-3
    assert torch.equal(got[1], adf.adaptive_resize_fused(img[1], s))
    planar = adf.adaptive_resize_fused(img, s, layout="planar")
    assert planar.shape == (3, s, h * s, w) and planar.dtype == torch.uint32
    assert torch.equal(adf.unpack_planar(planar, h, w, s, c), got)
    if c == 4:
        words = adf.adaptive_resize_fused(img[0], s, layout="hwc32")
        assert words.shape == (h * s, w * s) and words.dtype == torch.uint32
        assert torch.equal(words.view(torch.uint8).reshape(got[0].shape),
                           got[0])
        # kernel B interleaves kernel E's planar output into the same words
        assert torch.equal(
            ilv.interleave_planar_u32(planar[0]).view(torch.uint8),
            words.view(torch.uint8))
        opq = img.clone()
        opq[..., 3] = 255
        assert torch.equal(
            adf.adaptive_resize_fused(opq, s, opaque_alpha=True),
            adf.adaptive_resize_fused(opq, s))


@pytest.mark.cuda
def test_kernel_e_full_frame_and_staging_passes_on_card(cuda):
    img = _all_class_frames(0, 1, 1080, 1920, 4, cuda)
    cache = {}
    got = adf.adaptive_resize_fused(img, 4, weight_cache=cache)
    assert got.shape == (1, 4320, 7680, 4)
    mx, share = _diff_u8(got, adf.adaptive_resize_reference(
        img, *next(iter(cache.values())), 4))
    assert mx <= 1 and share < 1e-3
    # the output tile is staged in passes where it outgrows shared memory
    # (scales above 14), by row phases and then by column phases too; a
    # bound on the staged phases makes small scales take the same passes
    for c in (3, 4):
        small = _all_class_frames(1, 2, 19, 41, c, cuda)
        for s, stages in [(15, (0,)), (17, (0, 40, 5)), (5, (0, 12, 5, 3, 1)),
                          (4, (8, 2)), (3, (2,))]:
            wts = adf._weights(19, 41, s, -0.5, cuda, None)
            want = adf.adaptive_resize_reference(small, *wts, s)
            one_pass = None
            for stage in stages:
                got = adf.adaptive_resize_fused(small, s, stage_phases=stage)
                assert got.shape == (2, 19 * s, 41 * s, c)
                assert _diff_u8(got, want)[0] <= 1
                planar = adf.adaptive_resize_fused(
                    small, s, layout="planar", stage_phases=stage)
                assert torch.equal(adf.unpack_planar(planar, 19, 41, s, c),
                                   got)
                # the passes change where a pixel is staged, not its value
                one_pass = got if one_pass is None else one_pass
                assert torch.equal(got, one_pass)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 2, 3, 4, 15])
@pytest.mark.parametrize("c", [1, 2])
def test_kernel_e_gray_and_two_channel_frames_on_card(cuda, c, s):
    """Kernel E at C = 1 and 2: rows of w*s*C bytes that are not whole
    words (37 and 41 columns), classes equal to the plain version's at
    every pixel, the planar words' bytes above C zero; at s = 15 the tile
    is staged in passes, and a bound on the staged phases makes s = 4 take
    them too."""
    from bicubic_interpolation_model_tpu_torch.ops.adaptive import (
        luma_bt709, region_classes)
    for h, w in [(13, 37), (24, 70), (19, 41)]:
        img = _all_class_frames(h + s + c, 3, h, w, c, cuda)
        cache = {}
        cls = torch.empty((3, h, w), dtype=torch.uint8, device=cuda)
        before = adf.adaptive_resize_fused.launches
        got = adf.adaptive_resize_fused(img, s, weight_cache=cache,
                                        classes_out=cls)
        assert adf.adaptive_resize_fused.launches == before + 1
        assert got.shape == (3, h * s, w * s, c) and got.dtype == torch.uint8
        assert float(got.float().std()) > 0
        wts = next(iter(cache.values()))
        assert torch.equal(cls, region_classes(luma_bt709(img.float())))
        assert len(torch.unique(cls)) == 3 or h * w < 1000
        mx, share = _diff_u8(got, adf.adaptive_resize_reference(img, *wts, s))
        assert mx <= 1 and share < 1e-3
        mx64, share64 = _diff_u8(got, adf.adaptive_resize_reference(
            img, *wts, s, dtype=torch.float64))
        assert mx64 <= 1 and share64 < 1e-3
        for i in range(3):
            assert torch.equal(got[i], adf.adaptive_resize_fused(img[i], s))
        planar = adf.adaptive_resize_fused(img, s, layout="planar")
        assert planar.shape == (3, s, h * s, w)
        assert torch.equal(adf.unpack_planar(planar, h, w, s, c), got)
        assert not planar.view(torch.uint8).reshape(-1, 4)[:, c:].any()
        with pytest.raises(ValueError, match="4 channels"):
            adf.adaptive_resize_fused(img, s, layout="hwc32")
        if s == 4:
            for stage in (5, 2):
                assert torch.equal(
                    adf.adaptive_resize_fused(img, s, stage_phases=stage), got)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [1, 2])
def test_adaptive_routes_gray_and_two_channel_frames_to_kernel_e_on_card(
        cuda, c):
    from bicubic_interpolation_model_tpu_torch.ops.adaptive import (
        adaptive_resize, adaptive_resize_batch)
    from bicubic_interpolation_model_tpu_torch.serving import Upscaler
    frames = _all_class_frames(40 + c, 3, 20, 27, c).numpy()
    img = frames[0]
    e0 = adf.adaptive_resize_fused.launches
    out = adaptive_resize(img, 4)
    assert out.is_cuda and out.shape == (80, 108, c)
    assert adf.adaptive_resize_fused.launches == e0 + 1
    assert _diff_u8(out, adaptive_resize(img, 4, impl="jnp"))[0] <= 1
    assert torch.equal(adaptive_resize(img, 4, impl="pallas"), out)
    assert adf.adaptive_resize_fused.launches == e0 + 2    # jnp: the graph
    # the Upscaler: one launch per frame by __call__ and stream, one per
    # batch; frames of fewer than 4 channels stay bytes without the fetch
    up = Upscaler(scale=4, method="adaptive")
    dev = up(img, fetch=False)
    assert dev.dtype == torch.uint8 and torch.equal(dev, out)
    np.testing.assert_array_equal(up(img), out.cpu().numpy())
    streamed = list(up.stream(list(frames)))
    b = up.batch(frames)
    assert b.shape == (3, 80, 108, c)
    assert adf.adaptive_resize_fused.launches == e0 + 2 + 2 + 3 + 1
    for k in range(3):
        np.testing.assert_array_equal(streamed[k], b[k])
    assert torch.equal(adaptive_resize_batch(frames, 4)[0], out)


@pytest.mark.cuda
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("s", [1, 2, 3, 4])
def test_kernel_f_matches_plain_on_card(cuda, method, s):
    for h, w, c in [(23, 37, 4), (40, 70, 3), (13, 9, 1), (7, 5, 6)]:
        img = _frames(h + s, 2, h, w, c, cuda)
        cache = {}
        before = banded.resize_banded.launches
        got = banded.resize_banded(img, s, method, weight_cache=cache)
        assert banded.resize_banded.launches == before + 1
        b_row, b_colt, left = next(iter(cache.values()))[:3]
        ref = banded.resize_banded_reference(img, b_row, b_colt, s, left)
        mx, share = _diff_u8(got, ref)
        assert mx <= 1 and share < 1e-3
        assert mx == 0 or method != "nearest"
        assert _diff_u8(got, banded.resize_banded_reference(
            img, b_row, b_colt, s, left, dtype=torch.float64))[0] <= 1
        assert torch.equal(got[1], banded.resize_banded(img[1], s, method))
        if c <= 4:
            assert _diff_u8(got, mxu.resize_mxu(img, s, method))[0] <= 1
        gf = banded.resize_banded(img.float(), s, method)
        rf = banded.resize_banded_reference(img.float(), b_row, b_colt, s,
                                            left)
        assert gf.dtype == torch.float32
        assert float((gf - rf).abs().max()) < 1e-3


@pytest.mark.cuda
def test_kernel_f_full_frame_and_shared_memory_limit_on_card(cuda):
    big = _frames(6, 1, 1080, 1920, 4, cuda)
    got = banded.resize_banded(big, 4, "bicubic")
    mx, share = _diff_u8(got, mxu.resize_mxu(big, 4, "bicubic"))
    assert got.shape == (1, 4320, 7680, 4) and mx <= 1 and share < 1e-3
    small = _frames(7, 1, 9, 9, 1, cuda)
    assert banded.resize_banded(small, 24, "nearest").shape == (1, 216, 216, 1)
    with pytest.raises(ValueError, match="shared memory"):
        banded.resize_banded(small, 40, "lanczos")


@pytest.mark.cuda
def test_adaptive_and_banded_route_to_the_kernels_on_card(cuda):
    from bicubic_interpolation_model_tpu_torch.ops.adaptive import (
        adaptive_resize, adaptive_resize_batch)
    from bicubic_interpolation_model_tpu_torch.ops.resize import resize
    from bicubic_interpolation_model_tpu_torch.serving import Upscaler
    frames = _all_class_frames(9, 3, 20, 24, 4).numpy()
    img = frames[0]
    e0, f0 = adf.adaptive_resize_fused.launches, banded.resize_banded.launches
    # auto on the card takes kernel E for 3 and 4 channels
    out = adaptive_resize(img, 4)
    rgb = adaptive_resize(img[..., :3], 4)
    assert out.is_cuda and rgb.is_cuda
    assert adf.adaptive_resize_fused.launches == e0 + 2
    assert _diff_u8(out, adaptive_resize(img, 4, impl="jnp"))[0] <= 1
    assert _diff_u8(rgb, adaptive_resize(img[..., :3], 4, impl="jnp"))[0] <= 1
    assert adf.adaptive_resize_fused.launches == e0 + 2    # jnp: the graph
    # numpy frames handed to the wrappers themselves go to the card
    assert adf.adaptive_resize_fused(img, 2).is_cuda
    assert banded.resize_banded(img, 2).is_cuda
    e0, f0 = e0 + 3, f0 + 1
    # what kernel E does not take goes to the plain graph
    five = np.concatenate([img, img[..., :1]], axis=-1)
    assert adaptive_resize(five, 2).shape == (40, 48, 5)
    assert adf.adaptive_resize_fused.launches == e0
    # no scale is left to the plain graph
    assert adaptive_resize(img[:4, :4], 15).shape == (60, 60, 4)
    assert adf.adaptive_resize_fused.launches == e0 + 1
    e0 += 1
    with pytest.raises(ValueError, match="1 to 4 channels"):
        adaptive_resize(five, 2, impl="pallas")
    # the Upscaler: words without the fetch, bytes with it, one launch per
    # frame by __call__ and stream, one per batch
    up = Upscaler(scale=4, method="adaptive")
    words = up(img, fetch=False)
    assert words.dtype == torch.uint32 and words.shape == (80, 96)
    host = up(img)
    assert host.shape == (80, 96, 4) and host.dtype == np.uint8
    np.testing.assert_array_equal(host, out.cpu().numpy())
    assert up(img[..., :3], fetch=False).dtype == torch.uint8
    streamed = list(up.stream(list(frames), microbatch=3))
    b = up.batch(frames)
    assert b.shape == (3, 80, 96, 4)
    assert adf.adaptive_resize_fused.launches == e0 + 3 + 3 + 1
    for k in range(3):
        np.testing.assert_array_equal(streamed[k], b[k])
    assert torch.equal(adaptive_resize_batch(frames, 4)[0], out)
    assert Upscaler(scale=4, method="adaptive", bucket=16)(img).shape == (
        80, 96, 4)
    # impl="pallas" of the classical resize is kernel F
    got = resize(img, 3, impl="pallas")
    assert banded.resize_banded.launches == f0 + 1
    assert _diff_u8(got, resize(img, 3, impl="gather"))[0] <= 1
    assert Upscaler(scale=2, impl="pallas").batch(frames).shape == (
        3, 40, 48, 4)
    assert banded.resize_banded.launches == f0 + 2


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,c,halo", [g + ("zero",) for g in GEOMETRIES]
                         + [(87, 510, 4, "rows"), (11, 21, 3, "rows"),
                            (3, 9, 1, "rows"), (9, 17, 2, "zero")])
def test_kernel_g_matches_plain_on_card(cuda, h, w, c, halo):
    args = _map_args(h, w, c, halo, seed=h + w, device=cuda)
    before = pt.packed_tail.launches
    got = pt.packed_tail(*args, layout="planar", halo=halo)
    assert pt.packed_tail.launches == before + 1
    assert got.shape == (4, 4 * h, w)
    ref = pt.packed_tail_reference(*args, halo=halo)
    mx, share = _diff(got, ref)
    assert mx <= 1 and share < 1e-3
    assert float(got.view(torch.uint8).float().std()) > 0
    bf = (args[0].to(torch.bfloat16),) + args[1:]
    gb = pt.packed_tail(*bf, layout="planar", halo=halo)
    assert _diff(gb, pt.packed_tail_reference(*bf, halo=halo))[0] <= 2


@pytest.mark.cuda
@pytest.mark.parametrize("halo", ["zero", "rows"])
def test_kernel_g_opaque_alpha_and_layouts_on_card(cuda, halo):
    args = _map_args(21, 45, 4, halo, seed=5, device=cuda, opaque=True)
    got = pt.packed_tail(*args, layout="planar", opaque_alpha=True,
                         halo=halo)
    ref = pt.packed_tail_reference(*args, opaque_alpha=True, halo=halo)
    assert _diff(got, ref)[0] <= 1
    planar = pt.packed_tail(*args, layout="planar", halo=halo)
    hwc = pt.packed_tail(*args, halo=halo)
    words = pt.packed_tail(*args, layout="hwc32", halo=halo)
    assert hwc.shape == (84, 180, 4) and words.shape == (84, 180)
    assert torch.equal(pt.unpack_planar(planar, 21, 45, 4, 4), hwc)
    assert torch.equal(words.contiguous().view(torch.uint8).reshape(
        hwc.shape), hwc)
    # a map lying at an odd offset is copied, not misread
    odd = torch.empty(args[0].numel() + 1, device=cuda)[1:].view(
        args[0].shape).copy_(args[0])
    assert torch.equal(pt.packed_tail(odd, *args[1:], halo=halo), hwc)


@pytest.mark.cuda
def test_kernel_g_refuses_what_it_does_not_take(cuda):
    m, lr, kout, bout = _map_args(8, 8, 4, "rows", seed=1, device=cuda)
    with pytest.raises(ValueError, match="h\\+3"):
        pt.packed_tail(m, lr[:-1], kout, bout, halo="rows")
    with pytest.raises(ValueError, match="c<=4"):
        pt.packed_tail(m, torch.zeros((11, 8, 5), device=cuda), kout, bout,
                       halo="rows")
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        pt.packed_tail(m.double(), lr, kout, bout, halo="rows")
    with pytest.raises(ValueError, match="several devices"):
        pt.packed_tail(m, lr.cpu(), kout, bout, halo="rows")
    with pytest.raises(ValueError, match="halo"):
        pt.packed_tail(m, lr, kout, bout, halo="same")


def _card_mesh(cuda, n, axis="spatial"):
    from bicubic_interpolation_model_tpu_torch.parallel.mesh import Mesh
    return Mesh([cuda] * n, (axis,))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 4])
def test_sharded_learned_on_card(cuda, n):
    from bicubic_interpolation_model_tpu_torch.evaluation.model_analysis \
        import _load_model_any
    from bicubic_interpolation_model_tpu_torch.models.inference import (
        super_resolve)
    from bicubic_interpolation_model_tpu_torch.parallel.spatial import (
        learned_resize_spatial_sharded)
    model, params = _load_model_any(ROOT / "model" / "wp-1e-3-120")
    img = _frames(n, 1, 24, 40, 4)[0].numpy()
    img[..., 3] = 255
    mesh = _card_mesh(cuda, n)
    g0, a0 = pt.packed_tail.launches, pt.packed_tail_fused.launches
    got = learned_resize_spatial_sharded(model, params, img, 4, mesh=mesh)
    assert got.is_cuda and got.shape == (96, 160, 4)
    assert (pt.packed_tail.launches, pt.packed_tail_fused.launches) == (
        g0 + n, a0)
    graph = learned_resize_spatial_sharded(model, params, img, 4, mesh=mesh,
                                           tail="graph")
    mx, share = _diff(got, graph)
    assert mx <= 1 and share < 1e-3
    single = super_resolve(model, params, img, convention="train")
    assert _diff(got, single)[0] <= 2


@pytest.mark.cuda
def test_sharded_classical_adaptive_and_batch_on_card(cuda):
    from bicubic_interpolation_model_tpu_torch.parallel.batch import (
        resize_batch_sharded)
    from bicubic_interpolation_model_tpu_torch.parallel.spatial import (
        adaptive_resize_spatial_sharded, resize_spatial_sharded)
    mesh = _card_mesh(cuda, 4)
    img = _frames(3, 1, 32, 24, 4, cuda)[0]
    for method in ("nearest", "bilinear", "bicubic", "lanczos"):
        c0 = mxu.resize_mxu.launches
        got = resize_spatial_sharded(img, 4, method, mesh=mesh)
        assert mxu.resize_mxu.launches == c0 + 4
        assert torch.equal(got, mxu.resize_mxu(img, 4, method))
        ein = resize_spatial_sharded(img, 4, method, mesh=mesh, impl="einsum")
        assert _diff_u8(got, ein)[0] <= 1
    frame = _all_class_frames(4, 1, 32, 40, 4, cuda)[0]
    e0 = adf.adaptive_resize_fused.launches
    got = adaptive_resize_spatial_sharded(frame, 4, mesh=mesh)
    assert adf.adaptive_resize_fused.launches == e0 + 4
    assert torch.equal(got, adf.adaptive_resize_fused(frame, 4))
    planar = adaptive_resize_spatial_sharded(frame, 4, mesh=mesh,
                                             layout="planar")
    assert torch.equal(planar, adf.adaptive_resize_fused(frame, 4,
                                                         layout="planar"))
    imgs = _frames(5, 8, 16, 12, 3, cuda)
    d0 = phase.resize_phase.launches
    out = resize_batch_sharded(imgs, 4, mesh=_card_mesh(cuda, 4, "data"))
    assert phase.resize_phase.launches == d0 + 4
    assert out.is_cuda and torch.equal(out, phase.resize_phase(imgs, 4))


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 3])
def test_kernels_c_and_e_on_ragged_tile_counts_on_card(cuda, batch):
    """Frames whose tile count is no multiple of the 132 SMs (kernel C's
    persistent blocks walk 32 x 128-pixel tiles, kernel E launches one
    block per 8 x 32 LR pixels), ragged at both edges, batches of 1 and 3;
    kernel C at integer and rational scales with u8 and f32 input, and on a
    band-sharded frame whose bands split its 4-row groups; kernel E in all
    three layouts and in passes."""
    from bicubic_interpolation_model_tpu_torch.parallel.spatial import (
        resize_spatial_sharded)
    img = _frames(batch, batch, 203, 331, 4, cuda)
    for scale in (4, 2.5, 1.25):
        cache = {}
        got = mxu.resize_mxu(img, scale, "bicubic", weight_cache=cache)
        ops = next(iter(cache.values()))
        mx, share = _diff_u8(got, mxu.resize_mxu_reference(img, *ops[:4]))
        assert mx <= 1 and share < 1e-3
        assert torch.equal(got[-1], mxu.resize_mxu(img[-1], scale, "bicubic"))
        gf = mxu.resize_mxu(img.float(), scale, "bicubic")
        assert float((gf - mxu.resize_mxu_reference(
            img.float(), *ops[:4])).abs().max()) < 1e-3
    # 12 rows x 3 over 4 bands: 9 output rows per band
    frame = _frames(8, 1, 12, 50, 3, cuda)[0]
    assert torch.equal(resize_spatial_sharded(frame, 3, "lanczos",
                                              mesh=_card_mesh(cuda, 4)),
                       mxu.resize_mxu(frame, 3, "lanczos"))
    for c in (3, 4):
        frames = _all_class_frames(batch + c, batch, 203, 331, c, cuda)
        for s, stage in ((4, 0), (3, 0), (4, 2), (15, 0)):
            wts = adf._weights(203, 331, s, -0.5, cuda, None)
            got = adf.adaptive_resize_fused(frames, s, stage_phases=stage)
            mx, share = _diff_u8(got, adf.adaptive_resize_reference(
                frames, *wts, s))
            assert mx <= 1 and share < 1e-3
            planar = adf.adaptive_resize_fused(frames, s, layout="planar",
                                               stage_phases=stage)
            assert torch.equal(adf.unpack_planar(planar, 203, 331, s, c), got)
            assert torch.equal(got[-1], adf.adaptive_resize_fused(
                frames[-1], s, stage_phases=stage))
            if c == 4:
                opq = frames.clone()
                opq[..., 3] = 255
                assert _diff_u8(adf.adaptive_resize_fused(
                    opq, s, opaque_alpha=True, stage_phases=stage),
                    adf.adaptive_resize_reference(
                        opq, *wts, s, opaque_alpha=True))[0] <= 1


@pytest.mark.cuda
def test_stream_keeps_every_frame_and_equals_calls_on_card(cuda):
    """stream() on the card stages each copy through pinned memory on a
    side stream; every yielded frame, kept in a list, equals __call__'s
    bytes in order, over shapes that break the groups."""
    from bicubic_interpolation_model_tpu_torch.serving import (
        ModelUpscaler, Upscaler)
    rng = np.random.default_rng(11)
    a = rng.integers(0, 256, (4, 40, 56, 4), dtype=np.uint8)
    b = rng.integers(0, 256, (2, 24, 32, 4), dtype=np.uint8)
    seq = [a[0], a[1], b[0], a[2], a[3], b[1]]
    servers = [Upscaler(scale=4), Upscaler(scale=2.5),
               Upscaler(scale=4, method="adaptive"),
               ModelUpscaler(str(ROOT / "model" / "wp-1e-3-120"))]
    for server in servers:
        for microbatch in ("auto", 2, None):
            kept = list(server.stream(iter(seq), microbatch=microbatch))
            assert len(kept) == len(seq)
            for frame, got in zip(seq, kept):
                assert isinstance(got, np.ndarray) and got.dtype == np.uint8
                np.testing.assert_array_equal(got, server(frame))


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,batch", [
    (9, 20, 1),      # fewer tiles than persistent blocks
    (203, 331, 3),   # a batch whose blocks' tiles cross frames
    (37, 43, 2)])    # odd widths: partial vector stores at every scale
def test_kernels_d_and_f_on_ragged_tiles_on_card(cuda, h, w, batch):
    """Kernels D (persistent blocks over 8 x 32 LR tiles, phase groups of
    4, stores of s*C bytes) and F (persistent runs of 8 x 32 LR tiles,
    tensor-core products over ranged k8 blocks, 8-byte pixel pairs) at
    frames ragged for their tiles and stores: C = 1..4, scales 2, 3, 4, u8
    and f32 input, every batch frame equal to its single frame."""
    for c in (1, 2, 3, 4):
        img = _frames(h * c + w, batch, h, w, c, cuda)
        for s in (2, 3, 4):
            cache = {}
            got = phase.resize_phase(img, s, "bicubic", weight_cache=cache)
            wts = next(iter(cache.values()))[:4]
            mx, share = _diff_u8(got, phase.resize_phase_reference(
                img, *wts[:2], s, *wts[2:]))
            assert mx <= 1 and share < 1e-3
            planar = phase.resize_phase(img, s, "bicubic", layout="planar")
            assert torch.equal(phase.interleave_planar(planar, h, w, s, c),
                               got)
            assert torch.equal(got[-1], phase.resize_phase(img[-1], s))
            gf = phase.resize_phase(img.float(), s, "bicubic")
            assert float((gf - phase.resize_phase_reference(
                img.float(), *wts[:2], s, *wts[2:])).abs().max()) < 1e-3
            cache = {}
            got = banded.resize_banded(img, s, "bicubic", weight_cache=cache)
            b_row, b_colt, left = next(iter(cache.values()))[:3]
            mx, share = _diff_u8(got, banded.resize_banded_reference(
                img, b_row, b_colt, s, left))
            assert mx <= 1 and share < 1e-3
            assert torch.equal(got[-1], banded.resize_banded(img[-1], s))
            gf = banded.resize_banded(img.float(), s, "bicubic")
            assert float((gf - banded.resize_banded_reference(
                img.float(), b_row, b_colt, s, left)).abs().max()) < 1e-3


@pytest.mark.cuda
def test_batch_sharded_equals_single_frame_kernel_d_on_card(cuda):
    """parallel/batch.resize_batch_sharded runs kernel D once per shard;
    its frames are byte-equal to kernel D on each frame alone."""
    from bicubic_interpolation_model_tpu_torch.parallel.batch import (
        resize_batch_sharded)
    imgs = _frames(11, 8, 45, 67, 4, cuda)
    d0 = phase.resize_phase.launches
    out = resize_batch_sharded(imgs, 4, mesh=_card_mesh(cuda, 4, "data"))
    assert phase.resize_phase.launches == d0 + 4
    for i in range(8):
        assert torch.equal(out[i], phase.resize_phase(imgs[i], 4))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["espcn_medium", "esrgan_lite"])
def test_direct_model_upscaler_matches_float64_on_card(cuda, name):
    """A direct model served on the card against the same module with its
    params and input in float64 on the card."""
    from bicubic_interpolation_model_tpu_torch.models.inference import (
        super_resolve_direct)
    from bicubic_interpolation_model_tpu_torch.serving import ModelUpscaler
    up = ModelUpscaler(str(ROOT / "model" / name))
    frames = _frames(40, 2, 24, 36, 4).numpy()
    got = [torch.from_numpy(up(f)).to(cuda) for f in frames]
    for f, g in zip(frames, got):
        assert g.shape == (96, 144, 3)
        ref = super_resolve_direct(up.model, up.params,
                                   torch.from_numpy(f[..., :3]).to(cuda),
                                   compute_dtype=torch.float64)
        mx, share = _diff_u8(g, ref)
        assert mx <= 1 and share < 1e-3, (mx, share)
        assert float(g.float().std()) > 0
    batch = up.batch(frames, fetch=False)
    for b, g in zip(batch, got):
        assert _diff_u8(b, g)[0] <= 1


@pytest.mark.cuda
def test_weight_predictor_train_step_on_card_equals_cpu(cuda):
    """One WeightPredictor train step (full width, a patch batch of the
    TrainConfig defaults: 8 x 64x64 LR) on the card against the same step
    on the CPU from the same parameters and batch: the loss within 1e-5
    relative, the parameters within 1e-6 (cuDNN's f32 convs with TF32 off,
    forward and backward)."""
    from bicubic_interpolation_model_tpu_torch.data.onthefly import (
        target_tiles)
    from bicubic_interpolation_model_tpu_torch.models.weight_predictor import (
        WeightPredictor)
    from bicubic_interpolation_model_tpu_torch.train import trainer as tr
    rng = np.random.default_rng(3)
    img = rng.random((8, 64, 64, 4), np.float32)
    off, y = (t[None].expand(8, *t.shape).contiguous()
              for t in target_tiles(64, 4, device="cpu"))
    mask = torch.ones((8, 256, 256, 1))
    base = tr.fresh_params(WeightPredictor(), "cpu", 0)
    out = {}
    for dev in ("cpu", cuda):
        params = tr.trainable(base, dev)
        opt = tr.adam(1e-4).init(params)
        step = tr.make_weight_predictor_step(WeightPredictor())
        params, opt, loss, _ = step(params, opt, img, off, y, mask)
        out[str(dev)] = (float(loss), [t.detach().cpu()
                                       for t in tr.leaves(params)])
    (lc, pc), (lg, pg) = out["cpu"], out[str(cuda)]
    assert abs(lg - lc) <= 1e-5 * lc
    assert max(float((a - b).abs().max()) for a, b in zip(pc, pg)) <= 1e-6


@pytest.mark.cuda
def test_harness_fence_holds_on_card(cuda):
    """performance_test's wall time of a CUDA workload is at least the
    CUDA-event time of the same work: the fence waits for the card."""
    from bicubic_interpolation_model_tpu_torch.bench import harness
    x = torch.randn(2048, 2048, device=cuda)
    work = lambda: [x @ x for _ in range(20)]
    work()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    work()
    b.record()
    b.synchronize()
    res = harness.performance_test(work, test_item="fence", runs=3,
                                   warmup=1, out_dir=None)
    assert min(res.wall_ms) >= 0.9 * a.elapsed_time(b)


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["pallas_mxu", "pallas_phase",
                                  "pallas_phase_planar", "pallas"])
def test_check_parity_at_the_bench_geometry_on_card(cuda, impl):
    """Kernels C, D (both layouts) and F at 1080x1920 RGBA -> 4x within 1
    u8 of the port's float64 oracle, every 67th output row."""
    from bicubic_interpolation_model_tpu_torch.bench import suite
    assert suite.check_parity(4, "bicubic", impl=impl, h=1080,
                              w=1920) <= 1


# ---- the probe instances of kernels D, E and G (bench/labs.py) ----------


def test_probe_entry_points_are_bound_and_cpu_probes_launch_nothing():
    """Each probed source has its second C entry point, bound beside the
    seven production ones; on CPU tensors the probe wrappers run their plain
    versions and count nothing."""
    from bicubic_interpolation_model_tpu_torch.bench import labs
    from bicubic_interpolation_model_tpu_torch.runtime import build
    names = {"bim_resize_phase_probe": "resize_phase.cu",
             "bim_adaptive_probe": "adaptive.cu",
             "bim_packed_tail_map_probe": "packed_tail_map.cu"}
    assert set(build._PROBE_SIGNATURES) == set(names)
    for symbol, src in names.items():
        assert f"int {symbol}(" in (build.CSRC / src).read_text()
    before = labs.read_counts()
    x = _frames(3, 1, 9, 13, 4)
    for case in (labs.d_cases(x) + labs.e_cases([x, x[..., :1]])
                 + labs.g_cases(*_map_args(5, 9, 4, "zero", seed=3))):
        err, ok = case.check(case.run(case.x), case.plain(case.x))
        assert ok and err == 0, case.name
    assert labs.read_counts() == before


def _probe_cases(kernel, dev):
    from bicubic_interpolation_model_tpu_torch.bench import labs
    if kernel == "D":
        return labs.d_cases(_frames(11, 2, 37, 70, 4, dev))
    if kernel == "E":
        x = _all_class_frames(12, 2, 40, 70, 4, dev)
        return labs.e_cases([x, x[..., :1].contiguous()])
    return labs.g_cases(*_map_args(19, 37, 4, "zero", seed=13, device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["D", "E", "G"])
def test_probe_instances_match_plain_on_card(cuda, kernel):
    """Every probe instance of a kernel (and its production instances) on
    the card against its plain version at the labs' tolerances
    (bench/labs.py), one launch counted per call."""
    for case in _probe_cases(kernel, cuda):
        n0 = case.launches()
        got = case.run(case.x)
        torch.cuda.synchronize()
        assert case.launches() == n0 + 1, case.name
        err, ok = case.check(got, case.plain(case.x))
        assert ok, (case.name, err)


def production_digests(dev) -> dict:
    """sha256 of the production instances' outputs of all seven kernels on
    seeded inputs (the same inputs for every revision of the port)."""
    import hashlib
    out = {}

    def put(name, t):
        out[name] = hashlib.sha256(
            t.contiguous().cpu().numpy().tobytes()).hexdigest()

    args = _tail_args(24, 40, 4, seed=71, device=dev)
    put("a_f32", pt.packed_tail_fused(*args, layout="planar"))
    put("a_bf16", pt.packed_tail_fused(args[0].to(torch.bfloat16),
                                       *args[1:], layout="planar"))
    rng = np.random.default_rng(72)
    planar = torch.from_numpy(rng.integers(0, 2 ** 32, (4, 96, 40),
                                           dtype=np.uint32)).to(dev)
    put("b", ilv.interleave_planar_u32(planar))
    img = _frames(73, 2, 43, 70, 4, dev)
    for scale in (2.5, 4):
        put(f"c_{scale}", mxu.resize_mxu(img, scale))
    put("c_f32", mxu.resize_mxu(img.float() / 3, 3))
    for layout in ("hwc", "planar"):
        put(f"d_{layout}", phase.resize_phase(img, 4, layout=layout))
    put("d_lanczos_3", phase.resize_phase(img[..., :3], 3, "lanczos"))
    put("d_f32", phase.resize_phase(img.float() / 3, 2))
    frames = _all_class_frames(74, 2, 40, 70, 4, dev)
    for c in (4, 3, 2, 1):
        x = frames[..., :c].contiguous()
        put(f"e_c{c}", adf.adaptive_resize_fused(x, 4))
        put(f"e_c{c}_planar", adf.adaptive_resize_fused(x, 4,
                                                        layout="planar"))
    put("e_passes", adf.adaptive_resize_fused(frames, 4, stage_phases=4))
    opaque = frames.clone()
    opaque[..., 3] = 255
    put("e_opaque", adf.adaptive_resize_fused(opaque, 3, opaque_alpha=True))
    put("f", banded.resize_banded(img, 4))
    put("f_lanczos", banded.resize_banded(img, 3, "lanczos"))
    for halo in ("zero", "rows"):
        m, lr, kout, bout = _map_args(19, 37, 4, halo, seed=75, device=dev)
        put(f"g_{halo}", pt.packed_tail(m, lr, kout, bout, layout="planar",
                                        halo=halo))
        put(f"g_{halo}_bf16", pt.packed_tail(
            m.to(torch.bfloat16), lr, kout, bout, layout="planar",
            halo=halo))
    return out


# sha256 of production_digests' outputs, recorded on an NVIDIA H100 80GB
# HBM3 from the port as it was before the probe instances were added
# (every kernel source then held only its production instances)
PRODUCTION_SHA256 = {
    "a_f32": "337891d6a9a0939aca2ba1d0dc39f7c5"
        "abe3c61bf52a7badc04339defdbd9cc7",
    "a_bf16": "e6447780a9409cf0f098e359bc2996e4"
        "00767681b6f421241a48cdaaa77f6663",
    "b": "43628bc89f1a211161f3cf1d4d84efe3"
        "c73f74b1b821f8f35621654234b74ae4",
    "c_2.5": "2c2612f14ac290476b715493b7635015"
        "a359d934a8b96a6dc7fd528e6989924c",
    "c_4": "8e4ddd20ebd11b1cff10ee415c8c3dff"
        "db956afe7cd4838cb111ccfb4a94559b",
    "c_f32": "72b30c2e6e89228211c69d6b6c447938"
        "327197c94e0ff7c80880ca5d0b797144",
    "d_hwc": "8e4ddd20ebd11b1cff10ee415c8c3dff"
        "db956afe7cd4838cb111ccfb4a94559b",
    "d_planar": "7f9656965b225963cb7f678ef95128bf"
        "990235f2b0b81204083e2d6be8198760",
    "d_lanczos_3": "e3b8bec6d17d739142cade3afbfdce1b"
        "0adffb572619c288f6d62bbd03aa4993",
    "d_f32": "99ebdcc8842051f6413fe7789fa86789"
        "cc848c79de3ecebe143ebc44df223d9b",
    "e_c4": "6c51cac5bc5d0119ad632017a5ef27cf"
        "f9e9ade11514732aef0bdf36a0a5f2e3",
    "e_c4_planar": "93781ded00840948bdba6861da3a98f5"
        "a153a2e3220c1059d9eb9d1fd89de2cb",
    "e_c3": "c4e067a05363b306a7ac4b3c286b47e9"
        "c3fe9b993b75efe0117c8d0e00b5df96",
    "e_c3_planar": "a3632b2da55e537f2a5811238415f938"
        "542b7194b08b484a744d766031d393fe",
    "e_c2": "9a7644b68bae50b1ff806963464d37d0"
        "fe5d3617716cbe252117a4a7adeea92f",
    "e_c2_planar": "c4e4c6d5bdb5ce16419bbe64d640aafa"
        "dd11682227c10d3c3d0ea9ad30c9d7ea",
    "e_c1": "dec242cdee6150c35b2ef582708e1695"
        "d0fceeba7191110fc9929dab0c0aff2f",
    "e_c1_planar": "861e0f27228f011147f5fe938b2ecd03"
        "97d2b03752f84f8e64f26c7842b8a0e1",
    "e_passes": "6c51cac5bc5d0119ad632017a5ef27cf"
        "f9e9ade11514732aef0bdf36a0a5f2e3",
    "e_opaque": "5800699e806afc8217d232987f9bebc7"
        "c85c52b525fa8b9834ed408b47dc0c86",
    "f": "39266aaa2b27c55da915e8632ec78547"
        "b17d930e0959073fa6a0b195b0f68332",
    "f_lanczos": "ef6924f2e10f660dc47d708ab72f5095"
        "b7ab1a506d96ef353edeb2ec13659ea2",
    "g_zero": "43074650fd34602b13707d466756b088"
        "c42415bbb99893dc373237bab7fddc8a",
    "g_zero_bf16": "35986a811a4ed5d1b56980943ffc5ac0"
        "1a8ce087a3dd32356d7d752136302f51",
    "g_rows": "73d54f504818ccc53845841704ecc08f"
        "c94c17cb431214705592194ea13ce0ec",
    "g_rows_bf16": "9e6100e12f96dba846a0d8a923e57cc7"
        "1ec6898049ded4e9c815747b519615f5",
}


@pytest.mark.cuda
def test_production_instances_match_recorded_bytes_on_card(cuda):
    """Every production instance of the seven kernels gives the bytes it
    gave before the probes were added to kernels D, E and G, on the same
    seeded inputs."""
    got = production_digests(cuda)
    assert got.keys() == PRODUCTION_SHA256.keys()
    assert {k for k in got if got[k] != PRODUCTION_SHA256[k]} == set()
