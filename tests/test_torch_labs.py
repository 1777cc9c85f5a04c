"""The plain versions of the port's probe instances (``bench/labs.py``:
kernels D, E and G with one stage cut or replaced) against the JAX
package's kernel labs, on the CPU at small frames.

Where the TPU lab exposes its Pallas function, the port's plain version is
held to it, run in interpret mode:

- ``scripts/kernel_lab.py`` ``resize_variant(variant="rowonly" | "null")``
  and ``resize_vP(to_hwc=False | True)`` against kernel D's probes
  ``rowonly`` (≤1 u8: the same row pass, rounded at the first column
  tap, with the rounding bias added at another step), ``null`` (the TPU
  lab broadcasts by concatenating its row tile S times; the port stores
  each LR pixel over its S x S block: the same bytes at mapped positions)
  and ``chw`` / the full resize (≤1 u8: the TPU lab folds the rounding
  bias into the row pass);
- ``scripts/mxu_lab.py`` ``resize_mxu`` against kernel C's plain version
  (≤1 u8, both against the float64 oracle's arithmetic);
- ``scripts/packed_tail_lab.py`` ``_probe_tail(mode=...)`` against kernel
  G's stage probes: ``matmul`` and ``tanh`` sum all four column phases of a
  pixel and truncate to an integer (the port keeps each phase's sum in
  float: their sum truncated is within 1 of the TPU lab's), ``relayout``
  against ``tanh`` (kernel G's apply reads the weights where the products
  leave them, so the lab's relayout stage is the tanh instance): the
  phase's own sum truncated (within 1), ``apply`` channel 0 rounded
  (≤1 u8), ``full`` the tail (≤1 u8).

Kernel E's TPU probes sit in closures (``scripts/adaptive_probe_lab.py``
``main``'s ``probe_kernel``, ``scripts/adaptive_lab.py`` ``cmd_ablate``'s
source transforms), so the port's plain versions are held to the
properties those sources state, each cited by line in its test.
"""

import importlib.util
import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bicubic_interpolation_model_tpu.ops import pallas_adaptive as jpa
from bicubic_interpolation_model_tpu.ops import pallas_packed_tail as jpt
from bicubic_interpolation_model_tpu_torch.bench import labs
from bicubic_interpolation_model_tpu_torch.bench.labs import all_class_frames
from bicubic_interpolation_model_tpu_torch.ops import adaptive_fused as adf
from bicubic_interpolation_model_tpu_torch.ops import mxu, phase
from bicubic_interpolation_model_tpu_torch.ops import packed_tail as pt
from bicubic_interpolation_model_tpu_torch.ops.adaptive import (
    TEXTURE, centre_offset, luma_bt709, region_classes)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _lab(name):
    """A JAX lab script of ``scripts/`` as a module (it is no package)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_lab_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def kernel_lab():
    return _lab("kernel_lab")


def _rgba(seed, h, w):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (1, h, w, 4), dtype=np.uint8)
    img[..., 3] = 255
    return img


# ---- kernel D: scripts/kernel_lab.py -----------------------------------


@pytest.mark.parametrize("s", [2, 4])
@pytest.mark.parametrize("layout", ["hwc", "planar"])
def test_rowonly_is_the_labs_rowonly(kernel_lab, s, layout):
    """kernel_rowonly (kernel_lab.py:213): the row pass, rounded, stored at
    window column X - left for every column phase; its HWC epilogue is the
    port's hwc layout, its planar output (epilogue "none") the port's
    planar one. ≤1 u8 with a share below 1e-3: the lab adds the rounding
    bias at the first tap, the port after the last."""
    img = _rgba(s, 24, 40)
    epilogue = "xla" if layout == "hwc" else "none"
    want = np.asarray(kernel_lab.resize_variant(
        jnp.asarray(img), "rowonly", s, step=8, wstep=40, epilogue=epilogue,
        interpret=True))
    got = phase.resize_phase_probe(torch.from_numpy(img), s, "rowonly",
                                   layout=layout, device="cpu").numpy()
    if layout == "planar":
        want = want[:, :, :24 * s, :40 * 4]
    d = np.abs(got.astype(int) - want.astype(int))
    assert d.max() <= 1 and (d != 0).mean() < 1e-3


@pytest.mark.parametrize("s", [2, 4])
def test_null_holds_the_labs_null_bytes(kernel_lab, s):
    """kernel_null (kernel_lab.py:232) stores the window's pixels rounded
    with no FMA, broadcast by concatenating its step-row tile S times: its
    output row i*step*S + k*step + r, column X*S + p holds LR pixel
    (i*step + r - left, X - left), zero before the image. The port's probe
    stores LR pixel (R // S, X) over its S x S block: the same pixels at
    mapped positions."""
    h, w, step, left = 24, 40, 8, 1
    img = _rgba(10 + s, h, w)
    jx = np.asarray(kernel_lab.resize_variant(
        jnp.asarray(img), "null", s, step=step, wstep=w,
        interpret=True))[0]
    got = phase.resize_phase_probe(torch.from_numpy(img), s, "null",
                                   device="cpu").numpy()[0]
    rows = np.arange(h * s)
    lr_row = (rows // (step * s)) * step + rows % step - left
    lr_col = np.arange(w * s) // s - left
    inside = (lr_row >= 0)[:, None] & (lr_col >= 0)[None, :]
    port_at = got[np.clip(lr_row, 0, None)[:, None] * s,
                  np.clip(lr_col, 0, None)[None, :] * s]
    assert np.array_equal(jx[inside], port_at[inside])
    assert not jx[~inside].any()
    assert np.array_equal(got, np.repeat(np.repeat(img[0], s, 0), s, 1))


@pytest.mark.parametrize("to_hwc", [False, True])
def test_chw_is_the_labs_vp(kernel_lab, to_hwc):
    """kernel_vP (kernel_lab.py:409, resize_vP :440) does both phase
    interleaves in the kernel: channel-planar [B, C, H*S, W*S] with
    to_hwc=False (the port's probe "chw"), HWC with to_hwc=True (kernel
    D's hwc layout); ≤1 u8 (the lab folds the rounding bias into its row
    pass)."""
    img = _rgba(20, 24, 40)
    want = np.asarray(kernel_lab.resize_vP(jnp.asarray(img), 4, step=8,
                                           wstep=40, to_hwc=to_hwc,
                                           interpret=True))
    x = torch.from_numpy(img)
    got = (phase.resize_phase(x, 4, device="cpu") if to_hwc else
           phase.resize_phase_probe(x, 4, "chw", device="cpu")).numpy()
    assert got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_phase_probes_refuse_what_the_kernel_does_not_take():
    x = torch.from_numpy(_rgba(1, 8, 8))
    with pytest.raises(ValueError, match="uint8 RGBA"):
        phase.resize_phase_probe(x[..., :3].contiguous(), 4, "null")
    with pytest.raises(ValueError, match="uint8 RGBA"):
        phase.resize_phase_probe(x.float(), 4, "rowonly")
    with pytest.raises(ValueError, match="layout='hwc'"):
        phase.resize_phase_probe(x, 4, "chw", layout="planar")
    with pytest.raises(ValueError, match="unknown probe"):
        phase.resize_phase_probe(x, 4, "vT")


# ---- kernel C: scripts/mxu_lab.py --------------------------------------


@pytest.mark.parametrize("method,s,h,w,c", [
    ("bicubic", 4.0, 23, 37, 4), ("bicubic", 2.5, 40, 64, 4),
    ("lanczos", 1.5, 40, 64, 4), ("bicubic", 3.0, 23, 37, 1)])
def test_mxu_lab_resize_is_kernel_c(method, s, h, w, c):
    """mxu_lab.resize_mxu (mxu_lab.py:217, the "vM" prototype of kernel C)
    against kernel C's plain version: ≤1 u8 (both are the oracle's
    arithmetic within 1 LSB; mxu_lab.check holds the lab to it)."""
    ml = _lab("mxu_lab")
    rng = np.random.default_rng(int(s * 10) + h)
    img = rng.integers(0, 256, (h, w, c), dtype=np.uint8)
    got = mxu.resize_mxu(torch.from_numpy(img), s, method,
                         device="cpu").numpy()
    out = ml.resize_mxu(jnp.asarray(img[None]), s, method, step_in=8,
                        wstep=64, interpret=True)
    want = ml.hwc(out, got.shape[0], got.shape[1], c)[0]
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


# ---- kernel G: scripts/packed_tail_lab.py ------------------------------


@pytest.fixture(scope="module")
def tail_case():
    rng = np.random.default_rng(31)
    h, w, c = 8, 12, 4
    m = rng.normal(0, 0.5, (h, w, 4, 4, 32)).astype(np.float32)
    lr = rng.integers(0, 256, (h, w, c)).astype(np.float32)
    kout = rng.normal(0, 0.05, (3, 3, 32, 16)).astype(np.float32)
    bout = rng.normal(0, 0.25, 16).astype(np.float32)
    return m, lr, kout, bout


@pytest.mark.parametrize("mode", ["matmul", "tanh", "relayout", "apply",
                                  "full"])
def test_tail_probes_are_the_labs_probe_tail(tail_case, mode):
    """_probe_tail (packed_tail_lab.py:54; modes cumulative, :373) in
    interpret mode against the port's stage probes (module docstring)."""
    pl = _lab("packed_tail_lab")
    m, lr, kout, bout = tail_case
    h, w = m.shape[:2]
    out = np.asarray(pl._probe_tail(
        jpt, *(jnp.asarray(a) for a in tail_case), mode=mode,
        interpret=True, step=8, wstep=128))
    args = [torch.from_numpy(a) for a in tail_case]
    if mode == "full":
        got = pt.packed_tail(*args).numpy()           # hwc uint8
        assert np.abs(got.astype(int) - out.astype(int)).max() <= 1
        return
    probe = "tanh" if mode == "relayout" else mode
    got = pt.packed_tail_probe(*args, probe).numpy()  # [4, 4h, w]
    want = out[:, :h * 4, :w].view(np.int32).astype(np.int64)
    if mode in ("matmul", "tanh"):
        # the lab sums all four column phases of the pixel, in every plane
        total = np.trunc(got.astype(np.float64).sum(axis=0))
        assert all(np.array_equal(want[q], want[0]) for q in range(4))
        assert np.abs(total - want[0]).max() <= 1
        assert np.abs(got).max() > 1                  # not a trivial sum
    elif mode == "relayout":
        assert np.abs(np.trunc(got) - want).max() <= 1
    else:
        assert np.abs(got.astype(np.int64) - want).max() <= 1
        assert got.max() <= 255 and want.max() > 0


def test_tail_probes_bf16_and_rows_halo(tail_case):
    """On a bf16 map the probes compute on the map's values with conv_out
    rounded to bf16, as kernel G's bf16 instance; "apply" is channel 0 of
    the full tail's words; "relayout" is no instance of its own."""
    m, lr, kout, bout = (torch.from_numpy(a) for a in tail_case)
    mb = m.to(torch.bfloat16)
    ref = pt.packed_tail_reference(mb, lr, kout, bout).view(torch.int32)
    apply = pt.packed_tail_probe(mb, lr, kout, bout, "apply")
    assert torch.equal(apply.view(torch.int32), ref & 0xff)
    tanh = pt.packed_tail_probe(mb, lr, kout, bout, "tanh")
    with pytest.raises(ValueError, match="unknown probe"):
        pt.packed_tail_probe(mb, lr, kout, bout, "relayout")
    assert not torch.equal(tanh, pt.packed_tail_probe(m, lr, kout, bout,
                                                      "tanh"))
    rng = np.random.default_rng(3)
    mr = torch.from_numpy(rng.normal(0, 0.5, (8, 12, 4, 4, 32)).astype(
        np.float32))
    lrr = torch.from_numpy(rng.integers(0, 256, (9, 12, 4)).astype(
        np.float32))
    rows = pt.packed_tail_probe(mr, lrr, kout, bout, "apply", halo="rows")
    assert torch.equal(rows.view(torch.int32), pt.packed_tail_reference(
        mr, lrr, kout, bout, halo="rows").view(torch.int32) & 0xff)


# ---- kernel E: scripts/adaptive_probe_lab.py, adaptive_lab.py ----------


def _e_frame(seed, c, s):
    x = torch.from_numpy(all_class_frames(np.random.default_rng(seed), 1,
                                          16, 24, 4)[..., :c].copy())
    return x, {p: adf.adaptive_probe(x, s, p, device="cpu")
               for p in adf.PROBES}


def _texture_outputs(x, s):
    """[1, H*S, W*S] True where the output pixel's centre is a texture
    centre (the one place the exemption term acts)."""
    cls = region_classes(luma_bt709(x.float()))[0].numpy()
    h, w = cls.shape
    cy = np.array([centre_offset(q, s) for q in range(s)])
    rows = np.minimum(np.arange(h)[:, None] + cy[None], h - 1).reshape(-1)
    cols = np.minimum(np.arange(w)[:, None] + cy[None], w - 1).reshape(-1)
    return (cls[rows][:, cols] == TEXTURE)[None]


@pytest.mark.parametrize("c", [4, 1])
@pytest.mark.parametrize("s", [2, 4])
def test_law_scratch_is_law_const(c, s):
    """adaptive_probe_lab.py:79 fills the factor maps with the constant 1
    (base * 0 + 1) that :100 reads back; :103-104 takes the constant 1
    itself: law_scratch and law_const give the same bytes."""
    x, out = _e_frame(40 + s, c, s)
    assert torch.equal(out["law_scratch"], out["law_const"])


@pytest.mark.parametrize("c", [4, 1])
@pytest.mark.parametrize("s", [2, 4])
def test_fma_only_differs_from_law_const_only_where_the_eq_term_acts(c, s):
    """adaptive_probe_lab.py:105-108: fma_only drops the exemption (eq)
    term that law_const keeps (:112-113). The two differ only at outputs
    whose centre is a texture centre (the only class whose law is not 1 at
    distance 0), and there they do differ."""
    x, out = _e_frame(50 + s, c, s)
    tex = _texture_outputs(x, s)
    assert tex.any() and not tex.all()
    diff = (out["fma_only"] != out["law_const"]).any(dim=-1).numpy()
    assert not diff[~tex].any()
    assert diff[tex].any()


@pytest.mark.parametrize("c", [4, 1])
@pytest.mark.parametrize("s", [2, 4])
def test_fma_only_is_the_unmodulated_tap_sum(c, s):
    """adaptive_probe_lab.py:107-108: with F = 1 and no eq term each tap
    weighs wy * wx, the Keys weights at the clamped taps: fma_only equals
    sum(wy wx pix) / sum(wy wx), rounded, computed here in float64 from
    the JAX package's own weight vectors (pallas_adaptive.row_vectors,
    col_vectors); ≤1 u8."""
    x, out = _e_frame(60 + s, c, s)
    img = x[0].numpy().astype(np.float64)
    h, w = img.shape[:2]
    wy = jpa.row_vectors(h, s, -0.5, h)[0].astype(np.float64)
    wx = jpa.col_vectors(w, s, -0.5, w)[:4 * s].astype(np.float64)
    wy = wy.reshape(h, s, 4)                           # [r, q, n]
    wx = wx.reshape(s, 4, w)                           # [p, m, x]
    ry = np.clip(np.arange(h)[:, None] + np.arange(4) - 1, 0, h - 1)
    cx = np.clip(np.arange(w)[:, None] + np.arange(4) - 1, 0, w - 1)
    pix = img[ry][:, :, cx]                            # [r, n, x, m, ch]
    acc = np.einsum("rqn,pmx,rnxmc->rqxpc", wy, wx, pix)
    wsum = np.einsum("rqn,pmx->rqxp", wy, wx)
    want = np.clip((acc / wsum[..., None] + 0.5).astype(np.int64), 0, 255)
    want = want.reshape(h * s, w * s, c)
    got = out["fma_only"][0].numpy().astype(np.int64)
    assert np.abs(got - want).max() <= 1


@pytest.mark.parametrize("c", [4, 1])
def test_noeq_differs_from_full_only_where_the_eq_term_acts(c):
    """adaptive_lab.py:117-121 ("noeq") replaces E + (A - E) * F by
    (A * F): the G2 = E * (1 - F) term is dropped, which is zero wherever
    F(0) = 1 (edge and flat centres). So noeq is within 1 u8 of the full
    kernel (another order of the same sums) away from texture centres."""
    s = 4
    x, out = _e_frame(70, c, s)
    full = adf.adaptive_resize_fused(x, s, device="cpu")
    tex = _texture_outputs(x, s)
    d = (out["noeq"].to(torch.int16) - full.to(torch.int16)).abs()
    d = d.amax(dim=-1).numpy()
    assert d[~tex].max() <= 1
    assert d[tex].max() >= 1


def test_nolaw_on_a_frame_of_one_luma_is_fma_only():
    """adaptive_lab.py:108-115 ("nolaw") replaces the law by one subtract
    of the tap's luma from the centre's; the port biases it by 1024 so
    every weight stays positive. On a frame of one colour and a varying
    alpha the luma is constant, every centre flat (no eq term) and every
    factor 1024: the normalised sum is fma_only's, within 1 u8."""
    rng = np.random.default_rng(80)
    img = np.empty((1, 16, 24, 4), np.uint8)
    img[..., :3] = (90, 160, 30)
    img[..., 3] = rng.integers(0, 256, (1, 16, 24))
    x = torch.from_numpy(img)
    nolaw = adf.adaptive_probe(x, 4, "nolaw", device="cpu")
    fma = adf.adaptive_probe(x, 4, "fma_only", device="cpu")
    assert (nolaw.to(torch.int16) - fma.to(torch.int16)).abs().max() <= 1
    assert nolaw[..., 3].float().std() > 10


def test_adaptive_probes_refuse_what_the_kernel_does_not_take():
    x = torch.zeros((8, 8, 2), dtype=torch.uint8)
    with pytest.raises(ValueError, match="1 or 4 channels"):
        adf.adaptive_probe(x, 4, "noeq", device="cpu")
    with pytest.raises(ValueError, match="scales 1 to 14"):
        adf.adaptive_probe(x[..., :1], 15, "noeq", device="cpu")
    with pytest.raises(ValueError, match="unknown probe"):
        adf.adaptive_probe(x[..., :1], 4, "vA3", device="cpu")


def test_lab_cases_name_the_tpu_lab_lines():
    """Every probe case names the TPU lab function it replaces, and each
    cited line opens that function (or holds the cited transform)."""
    x = torch.from_numpy(_rgba(2, 9, 11))
    m, lr, kout, bout = (torch.from_numpy(a) for a in (
        np.zeros((4, 6, 4, 4, 32), np.float32),
        np.zeros((4, 6, 4), np.float32), np.zeros((3, 3, 32, 16),
                                                  np.float32),
        np.zeros(16, np.float32)))
    cases = (labs.d_cases(x) + labs.e_cases([x])
             + labs.g_cases(m, lr, kout, bout))
    probes = [c for c in cases if c.probe != "full"]
    assert len(probes) == 5 + 5 + 6
    for case in probes:
        path, line = case.replaces.split(":")
        text = (ROOT / path).read_text().splitlines()[int(line) - 1]
        assert any(k in text for k in ("def ", "lambda s")), case.replaces


# ---- the stamped labs' --cpu tables -------------------------------------


@pytest.mark.parametrize("lab,args", [
    ("packed_tail_lab", ["--cpu"]),
    ("adaptive_probe_lab", ["--cpu", "--h", "24", "--w", "40"])])
def test_cpu_table_is_stamped_cpu(lab, args, tmp_path, monkeypatch):
    """The two labs whose tables ``results_torch/`` holds stamp them; a
    ``--cpu`` table says so (backend ``cpu``), so no CPU run can pass for
    a card run."""
    from bicubic_interpolation_model_tpu_torch.bench import configs
    monkeypatch.setattr(labs, "LAB_DIR", tmp_path)
    spec = importlib.util.spec_from_file_location(
        f"torch_{lab}", ROOT / "scripts" / f"torch_{lab}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.main([*args, "--commit", "test"]) == 0
    table = json.loads((tmp_path / f"{lab}.json").read_text())
    prov = table["_provenance"]
    assert prov["backend"] == table["backend"] == "cpu"
    assert prov["commit"] == "test" and prov["card"] == table["card"]
    assert prov["source_sha256"] == configs.source_sha256()
