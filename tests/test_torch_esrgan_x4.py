"""The published ESRGAN generator (``models/esrgan.RRDBNet``, MODEL_ZOO
``esrgan_x4``) on the port's direct path, against the benchmark's plain
reference (``benchmark/reference/esrgan_rrdb.py``, plain torch, its own
NumPy draw of the seeded weights), on the CPU; two card tests.

Tolerances:

- float64 before rounding: ≤1e-10 in [0, 1] units. Both sides run the
  same float32 weights in float64 with the same products summed in
  another order (the port channel-major with one buffer per dense block,
  the reference NCHW with concatenations);
  float64 leaves ~1e-16 relative per sum, and the trunk's ~66x growth and
  the 345 convs keep the difference near 1e-13.
- float32 bytes against float64 bytes: ≤1 u8, and a share of differing
  bytes ≤1e-3, the configuration's ``limits.mismatch_share``. A byte can
  differ only where the float64 value lies within the float32 error of a
  rounding edge; that error is ~1e-4 u8 here (about 1e-6 relative at a
  30 u8 spread), so the expected share is a few 1e-4 at most, and one
  TF32 pass (the benchmark's control, ~1e-3 relative) differs in a share
  of tens of percent.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import pathlib
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark import traffic  # noqa: E402
from benchmark.reference import esrgan_rrdb as ref  # noqa: E402
from bicubic_interpolation_model_tpu_torch.models import esrgan  # noqa: E402
from bicubic_interpolation_model_tpu_torch.models import (  # noqa: E402
    inference)
from bicubic_interpolation_model_tpu_torch.models.layers import (  # noqa: E402
    empty_module, tree_map)
from bicubic_interpolation_model_tpu_torch.models.zoo import (  # noqa: E402
    MODEL_ZOO, load_model)
from bicubic_interpolation_model_tpu_torch.ops.conv3x3 import (  # noqa: E402
    conv3x3_tc)
from bicubic_interpolation_model_tpu_torch.serving import (  # noqa: E402
    ModelUpscaler)

CELL_DIR = ROOT / "benchmark" / "configs" / "esrgan-rrdbnet-x4"
PUBLISHED = {"n_blocks": 23, "features": 64, "growth": 32}
SMALL = {"n_blocks": 2, "features": 16, "growth": 8}
LIMIT = 1e-3             # the configuration's limits.mismatch_share


def _init(seed=7, bias=(0.5, 0.5, 0.5)):
    return {"rng": esrgan.INIT_RNG, "seed": seed, "order": esrgan.INIT_ORDER,
            "kernel": esrgan.INIT_KERNEL,
            "scale": {"body": 0.1, "conv_first": 1.0, "conv_body": 0.1,
                      "conv_up1": 1.0, "conv_up2": 1.0, "conv_hr": 1.0,
                      "conv_last": 0.5},
            "bias": {"conv_last": list(bias)}}


def _ckpt(path, dims, **meta):
    path.mkdir(parents=True, exist_ok=True)
    (path / "meta.json").write_text(json.dumps(
        {"model": "esrgan_x4", "scale": 4, **dims, **meta}))
    return path


@pytest.fixture(scope="module")
def small_dir(tmp_path_factory):
    return _ckpt(tmp_path_factory.mktemp("esrgan_small"), SMALL,
                 init=_init())


@pytest.fixture(scope="module")
def published_dir(tmp_path_factory):
    return _ckpt(tmp_path_factory.mktemp("esrgan_published"), PUBLISHED,
                 init=_init(seed=11, bias=(0.45, 0.5, 0.55)))


@pytest.fixture(scope="module")
def cell():
    """The benchmark cell's checkpoint: the port's model and the
    reference's state, loaded once."""
    model, params = load_model(CELL_DIR, device="cpu")
    return model, params, ref.load(CELL_DIR, "cpu")


def _frame(h, w, c=3, seed=5):
    return traffic.frame(traffic.rng_for(seed, 0), h, w, c)


def _port_float64(model, params, img):
    x = torch.as_tensor(img[..., :3])[None].to(torch.float64) / 255.0
    return inference._apply_direct(model, params, x, torch.float64)[0]


# -- float64: the port's equations are the reference's -------------------

@pytest.mark.parametrize("which,h,w", [("small", 7, 9), ("published", 6, 8)])
def test_float64_port_matches_reference_before_rounding(which, h, w,
                                                        small_dir,
                                                        published_dir):
    d = small_dir if which == "small" else published_dir
    model, params = load_model(d, device="cpu")
    img = _frame(h, w)
    got = _port_float64(model, params, img)
    want = ref.upscale_float(ref.load(d, "cpu"), torch.as_tensor(img))
    assert got.shape == want.shape == (4 * h, 4 * w, 3)
    assert float((got - want).abs().max()) <= 1e-10
    assert float(want.std()) > 0.01          # not a constant output


def test_published_widths_and_parameter_count():
    model = empty_module(lambda: MODEL_ZOO["esrgan_x4"](), "cpu")
    assert isinstance(model, esrgan.RRDBNet)
    assert (model.n_blocks, model.features, model.growth) == (23, 64, 32)
    assert sum(p.numel() for p in model.parameters()) == 16_697_987
    convs = esrgan.published_convs()
    assert len(convs) == 1 + 23 * 15 + 5
    assert convs[1][:1] + convs[1][2:] == ("body.0.rdb1.conv1", 32, 64)
    assert convs[-6][0] == "body.22.rdb3.conv5"
    with pytest.raises(ValueError, match="4x"):
        esrgan.RRDBNet(scale=2, n_blocks=1, features=8, growth=4)


# -- float32 on the direct path against float64 ---------------------------

def test_f32_bytes_within_one_of_float64_at_published_widths(cell):
    model, params, state = cell
    img = _frame(24, 32, seed=9)
    got = ModelUpscaler(str(CELL_DIR), device="cpu")(img)
    want = ref.run(state, torch.as_tensor(img)).numpy()
    assert got.shape == want.shape == (96, 128, 3) and got.dtype == np.uint8
    d = np.abs(got.astype(int) - want)
    share = float((d > 0).mean())
    assert d.max() <= 1 and share <= LIMIT, share


def test_seeded_weights_leave_the_cell_output_unsaturated(cell):
    """At least 95% of the output bytes lie in 1..254 on crops of the
    cell's frames (the card run states the share at full frames)."""
    _, _, state = cell
    shares = []
    for seed in (1, 2):
        f = traffic.pool({"frame": [339, 510, 3], "pool": 1}, seed)[0]
        for y0, x0 in ((20, 40), (250, 420)):
            out = ref.run(state, torch.as_tensor(f[y0:y0 + 14,
                                                   x0:x0 + 18])).numpy()
            shares.append(float(((out >= 1) & (out <= 254)).mean()))
    assert min(shares) >= 0.95, shares


@pytest.mark.parametrize("entry", ["__call__", "batch", "stream"])
@pytest.mark.parametrize("channels", [3, 4])
def test_model_upscaler_serves_rgb_out(entry, channels, small_dir):
    up = ModelUpscaler(str(small_dir), device="cpu")
    frames = np.stack([_frame(7, 9, channels, seed=s) for s in (1, 2, 3)])
    if entry == "__call__":
        outs = [up(f) for f in frames]
    elif entry == "batch":
        outs = list(up.batch(frames))
    else:
        outs = list(up.stream(iter(frames), microbatch=2))
    state = ref.load(small_dir, "cpu")
    for f, out in zip(frames, outs):
        assert out.shape == (28, 36, 3) and out.dtype == np.uint8
        want = ref.run(state, torch.as_tensor(f)).numpy()
        assert np.abs(out.astype(int) - want).max() <= 1
        # an RGBA frame's alpha is dropped: its RGB alone gives the same
        assert np.array_equal(up(np.ascontiguousarray(f[..., :3])),
                              up(f))


# -- the channel-major forward with one buffer per dense block -----------

def _blocks():
    return esrgan.RRDBNet.buffered_blocks, esrgan.RRDBNet.concatenated_blocks


def test_loaded_kernels_are_oihw_contiguous_under_their_hwio_shape(
        small_dir):
    _, params = load_model(small_dir, device="cpu")
    leaves = list(_leaves(params["params"]))
    kernels = [v for k, v in leaves if k.endswith("kernel")]
    assert len(kernels) == 1 + 2 * 15 + 5
    for k in kernels:
        assert k.shape[:2] == (3, 3) and k.permute(3, 2, 0, 1).is_contiguous()


def test_buffered_forward_matches_the_concatenating_nhwc_forward(small_dir):
    """f32, within rounding: each conv sums its products in another order on
    NCHW than on NHWC, and each scaled residual is one fused ``a + 0.2 b``
    (at most 1 ulp from a multiply then an add); 1e-5 is ~40 ulps at the
    largest output, about 2.3 here, and each path's float64 error is about
    1.2e-6 on this frame. Rounded, the buffered path is ≤1 u8 from the
    plain reference."""
    model, params = load_model(small_dir, device="cpu")
    img = _frame(13, 17)
    x = torch.as_tensor(img)[None].float() / 255.0
    with torch.no_grad():
        buffered = model.apply(params, x)
    with torch.enable_grad():
        concatenated = model.apply(params, x).detach()
    assert buffered.shape == concatenated.shape == (1, 52, 68, 3)
    assert buffered.is_contiguous()
    assert float((buffered - concatenated).abs().max()) <= 1e-5
    got = inference.super_resolve_direct(model, params, img).numpy()
    want = ref.run(ref.load(small_dir, "cpu"), torch.as_tensor(img)).numpy()
    assert np.abs(got.astype(int) - want).max() <= 1


def test_counter_reads_every_dense_block_buffered_on_a_no_grad_frame(
        small_dir):
    model, params = load_model(small_dir, device="cpu")
    before = _blocks()
    inference.super_resolve_direct(model, params, _frame(7, 9))
    buffered, concatenated = (a - b for a, b in zip(_blocks(), before))
    assert (buffered, concatenated) == (3 * SMALL["n_blocks"], 0)


def _convs():
    return esrgan.RRDBNet.conv3x3_convs, esrgan.RRDBNet.cudnn_convs


def test_counters_read_the_convs_each_route_served(small_dir):
    """With grad off every conv but conv_first and conv_last goes through
    ``ops.conv3x3.conv3x3_tc`` (its plain version on the CPU): 15 a RRDB,
    conv_body, conv_up1, conv_up2 and conv_hr; with grad on all of them
    are cuDNN's, frame by frame."""
    model, params = load_model(small_dir, device="cpu")
    before = _convs()
    inference.super_resolve_direct(model, params, _frame(7, 9))
    kernel, cudnn = (a - b for a, b in zip(_convs(), before))
    assert (kernel, cudnn) == (15 * SMALL["n_blocks"] + 4, 2)
    x = torch.as_tensor(np.stack([_frame(5, 6, seed=s) for s in (1, 2)])
                        ).float() / 255.0
    before = _convs()
    with torch.enable_grad():
        model.apply(params, x)
    kernel, cudnn = (a - b for a, b in zip(_convs(), before))
    assert (kernel, cudnn) == (0, 2 * (15 * SMALL["n_blocks"] + 6))


def test_frames_the_conv_kernel_does_not_take_stay_channel_major_on_cudnn(
        small_dir):
    """A frame that ``ops.conv3x3.serves`` refuses (here on the meta device,
    shapes only; on the card any dtype but float32) still runs
    channel-major with grad off, one buffer per dense block, every conv on
    cuDNN with PyTorch's epilogue."""
    model, params = load_model(small_dir, device="cpu")
    meta = tree_map(lambda t: torch.empty(t.shape, device="meta"), params)
    before = _blocks() + _convs()
    with torch.no_grad():
        y = model.apply(meta, torch.empty((1, 7, 9, 3), device="meta"))
    assert y.shape == (1, 28, 36, 3)
    after = _blocks() + _convs()
    assert tuple(a - b for a, b in zip(after, before)) == (
        3 * SMALL["n_blocks"], 0, 0, 15 * SMALL["n_blocks"] + 6)


def test_cudnn_route_gives_the_kernel_routes_frame_bit_for_bit(
        small_dir, monkeypatch):
    """The channel-major forward's two routes for a conv, the kernel's
    wrapper (its plain version on the CPU) and cuDNN with PyTorch's
    epilogue, give the same float64 frame: the epilogues, residuals and
    strided destinations are wired alike."""
    model, params = load_model(small_dir, device="cpu")
    p64 = tree_map(lambda t: t.double(), params)
    x = torch.as_tensor(_frame(7, 9))[None].double() / 255.0
    with torch.no_grad():
        want = model.apply(p64, x)
        monkeypatch.setattr(esrgan, "serves", lambda t: False)
        before = _blocks() + _convs()
        got = model.apply(p64, x)
    after = _blocks() + _convs()
    assert tuple(a - b for a, b in zip(after, before)) == (
        3 * SMALL["n_blocks"], 0, 0, 15 * SMALL["n_blocks"] + 6)
    assert torch.equal(got, want)


def test_grad_enabled_falls_back_to_the_concatenating_blocks(small_dir):
    """The direct trainer's path: ``out=`` writes do not differentiate, so
    with grad on every dense block concatenates, and gradients reach the
    conv kernels."""
    model, params = load_model(small_dir, device="cpu")
    x = torch.as_tensor(np.stack([_frame(5, 6, seed=s) for s in (1, 2)])
                        ).float() / 255.0
    before = _blocks()
    with torch.enable_grad():
        model.apply(params, x).square().mean().backward()
    buffered, concatenated = (a - b for a, b in zip(_blocks(), before))
    assert (buffered, concatenated) == (0, 2 * 3 * SMALL["n_blocks"])
    for name, k in _leaves(params["params"]):
        if name.endswith("kernel"):
            assert k.grad is not None and float(k.grad.abs().max()) > 0, name


def test_batch_of_two_gives_the_frames_of_two_single_calls(small_dir):
    model, params = load_model(small_dir, device="cpu")
    frames = np.stack([_frame(7, 9, seed=s) for s in (3, 4)])
    before = _blocks()
    batch = inference.super_resolve_batch(model, params, frames).numpy()
    assert _blocks()[0] - before[0] == 2 * 3 * SMALL["n_blocks"]
    for f, out in zip(frames, batch):
        assert np.array_equal(
            out, inference.super_resolve_direct(model, params, f).numpy())


def test_esrgan_lite_output_is_unchanged_byte_for_byte():
    """ESRGANLite keeps the NHWC dense blocks and their arithmetic: its
    float32 output on a fixed draw, as the code before the channel-major
    RRDBNet forward gave it, is the same bytes."""
    model = esrgan.ESRGANLite(scale=4, features=8, growth=4, n_blocks=2,
                              generator=torch.Generator().manual_seed(22))
    x = torch.rand((1, 5, 7, 3), generator=torch.Generator().manual_seed(23))
    with torch.no_grad():
        y = model.apply(model.tree(), x)
    assert y.shape == (1, 20, 28, 3)
    assert y[0, 0, 0].tolist() == [0.4168108403682709, 0.1898249387741089,
                                   0.3668771982192993]
    assert hashlib.sha256(y.contiguous().numpy().tobytes()).hexdigest() == (
        "eaf548b9ed7ec2f82c3c4f5ec7c9e0cfbc7b86da1d3d655e869f47aba123fd62")


# -- weights: the seeded init and the published state dicts --------------

def test_seeded_loader_gives_the_reference_tensors_bit_for_bit(cell):
    model, params, state = cell
    init = json.loads((CELL_DIR / "meta.json").read_text())["init"]
    sd = esrgan.seeded_state_dict(init)
    drawn = ref.draw(init, 23, 64, 32)
    assert set(sd) == {f"{n}.{leaf}" for n in drawn
                       for leaf in ("weight", "bias")}
    for name, (w, b) in drawn.items():
        assert np.array_equal(sd[f"{name}.weight"], w), name
        assert np.array_equal(sd[f"{name}.bias"], b), name
    p = params["params"]
    for name, path, *_ in esrgan.published_convs():
        leaf = p
        for part in path:
            leaf = leaf[part]
        w, b = drawn[name]
        assert np.array_equal(leaf["kernel"].detach().numpy(),
                              w.transpose(2, 3, 1, 0))
        assert np.array_equal(leaf["bias"].detach().numpy(), b)
        w64, _ = state["weights"][name]
        assert torch.equal(w64, torch.as_tensor(w, dtype=torch.float64))


def test_seeded_init_that_states_another_draw_raises():
    init = _init()
    init["kernel"] = "float32(rng.normal(0, 0.1, (out, in, 3, 3)))"
    with pytest.raises(ValueError, match="another draw"):
        esrgan.seeded_state_dict(init, **SMALL)
    with pytest.raises(ValueError, match="does not make"):
        ref.draw(init, n_blocks=2, nf=16, gc=8)


def _xinntao(sd: dict) -> dict:
    """basicsr keys → xinntao's ``RRDBNet_arch.py`` keys."""
    top = {"conv_body": "trunk_conv", "conv_up1": "upconv1",
           "conv_up2": "upconv2", "conv_hr": "HRconv"}
    out = {}
    for k, v in sd.items():
        name, leaf = k.rsplit(".", 1)
        if name.startswith("body."):
            _, blk, rdb, cv = name.split(".")
            name = f"RRDB_trunk.{blk}.RDB{rdb[3:]}.{cv}"
        out[f"{top.get(name, name)}.{leaf}"] = v
    return out


def _state_dict(seed=3):
    return {k: torch.from_numpy(v) for k, v in esrgan.seeded_state_dict(
        _init(seed), **SMALL).items()}


def _trees_equal(a, b):
    flat = lambda t: {k: v for k, v in _leaves(t)}
    fa, fb = flat(a), flat(b)
    return set(fa) == set(fb) and all(torch.equal(fa[k], fb[k]) for k in fa)


def _leaves(t, prefix=""):
    for k, v in t.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("wrapper", [None, "params_ema", "params"])
@pytest.mark.parametrize("layout", ["basicsr", "xinntao"])
def test_published_state_dicts_load_to_the_seeded_tree(layout, wrapper,
                                                       tmp_path):
    sd = _state_dict()
    if layout == "xinntao":
        sd = _xinntao(sd)
        assert "RRDB_trunk.1.RDB3.conv5.weight" in sd and "HRconv.bias" in sd
    d = _ckpt(tmp_path / "ckpt", SMALL, state_dict="g.pth")
    torch.save({wrapper: sd} if wrapper else sd, d / "g.pth")
    _, got = load_model(d, device="cpu")
    seeded = _ckpt(tmp_path / "seeded", SMALL, init=_init(3))
    _, want = load_model(seeded, device="cpu")
    assert _trees_equal(got, want)


def _bad(kind, sd):
    if kind == "missing":
        del sd["body.1.rdb2.conv4.bias"]
    elif kind == "extra":
        sd["body.2.rdb1.conv1.weight"] = sd["body.1.rdb1.conv1.weight"]
    else:
        sd["conv_up1.weight"] = sd["conv_up1.weight"][:, :8]
    return sd


@pytest.mark.parametrize("kind,match", [("missing", "missing"),
                                        ("extra", "extra"),
                                        ("shape", "expected")])
def test_bad_state_dict_raises(kind, match, tmp_path):
    torch.save(_bad(kind, _state_dict()), tmp_path / "g.pth")
    d = _ckpt(tmp_path, SMALL, state_dict="g.pth")
    with pytest.raises(ValueError, match=match):
        load_model(d, device="cpu")


def test_meta_without_weights_raises(tmp_path):
    d = _ckpt(tmp_path, SMALL, init=_init())
    meta = json.loads((d / "meta.json").read_text())
    del meta["init"]
    with pytest.raises(ValueError, match="neither"):
        esrgan.load_rrdbnet(d, meta, device="cpu")


def test_trained_esrgan_x4_checkpoint_loads_by_msgpack(cell, tmp_path):
    """A checkpoint that the port's trainer writes (``params.msgpack`` and
    a ``meta.json`` naming ``esrgan_x4``, no init, no state dict) takes
    the MODEL_ZOO route and gives the same tree."""
    from bicubic_interpolation_model_tpu_torch.train import checkpoint
    _, params, _ = cell
    checkpoint.save(tmp_path, tree_map(lambda t: t.detach().numpy(), params),
                    meta={"model": "esrgan_x4", "scale": 4})
    model, got = load_model(tmp_path, device="cpu")
    assert isinstance(model, esrgan.RRDBNet)
    assert _trees_equal(got, params)


# -- spans ----------------------------------------------------------------

def test_trunk_and_upsample_spans_nest_in_model_step(small_dir, tmp_path):
    up = ModelUpscaler(str(small_dir), device="cpu")
    img = _frame(7, 9)
    up(img)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("__call__"):
            up(img)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
             for e in json.loads(path.read_text())["traceEvents"]
             if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    named = {n: [s for s in spans if s[2] == n]
             for n in ("model.step", "model.trunk", "model.upsample")}
    assert all(len(v) == 1 for v in named.values()), named
    (s0, s1, _), = named["model.step"]
    (t0, t1, _), = named["model.trunk"]
    (u0, u1, _), = named["model.upsample"]
    assert s0 <= t0 <= t1 <= u0 <= u1 <= s1


def test_span_split_script_runs_the_esrgan_path_on_the_cpu(small_dir,
                                                           capsys):
    """The script's plumbing on the ESRGAN path, served from the small
    seeded RRDBNet (the published widths are the card's; on the CPU they
    only cost time)."""
    path = ROOT / "scripts" / "torch_span_split.py"
    spec = importlib.util.spec_from_file_location("torch_span_split", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    module.MODELS["esrgan"] = small_dir
    assert module.main(["--cpu", "--path", "esrgan_div2k_call",
                        "--frames", "1"]) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["path"] == "esrgan_div2k_call" and row["frame"][2] == 3
    assert {"model.step", "model.trunk", "model.upsample"} <= set(
        row["spans"])
    assert row["spans"]["model.trunk"]["count"] == 1
    assert row["dense_blocks"] == {"buffered": 3 * SMALL["n_blocks"],
                                   "concatenated": 0}


# -- on the card -------------------------------------------------------------

@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cell's frame at 339x510 runs "
                    "on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_served_cell_frame_within_one_of_float64_on_card(card):
    img = traffic.pool({"frame": [339, 510, 3], "pool": 1}, 2147483700)[0]
    got = ModelUpscaler(str(CELL_DIR))(img)
    want = ref.run(ref.load(CELL_DIR, card),
                   torch.as_tensor(img).to(card)).cpu().numpy()
    d = np.abs(got.astype(int) - want)
    assert got.shape == (1356, 2040, 3)
    assert d.max() <= 1 and float((d > 0).mean()) <= LIMIT
    assert float(((want >= 1) & (want <= 254)).mean()) >= 0.95


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float64])
def test_other_precisions_stay_channel_major_on_cudnn_on_card(card, dtype,
                                                              small_dir):
    """bf16 (the opt-in) and float64 (the reference) frames on the card
    run channel-major with buffered dense blocks and every conv on cuDNN:
    the kernel takes float32 alone and is not launched; float64 is within
    one byte of the same function on the CPU."""
    model, params = load_model(small_dir, device=card)
    img = _frame(37, 53)
    before = _blocks() + _convs() + (conv3x3_tc.launches,)
    got = inference.super_resolve_direct(model, params, img,
                                         compute_dtype=dtype).cpu().numpy()
    after = _blocks() + _convs() + (conv3x3_tc.launches,)
    assert tuple(a - b for a, b in zip(after, before)) == (
        3 * SMALL["n_blocks"], 0, 0, 15 * SMALL["n_blocks"] + 6, 0)
    assert got.shape == (148, 212, 3)
    if dtype == torch.float64:
        cpu_model, cpu_params = load_model(small_dir, device="cpu")
        want = inference.super_resolve_direct(
            cpu_model, cpu_params, img, compute_dtype=dtype).numpy()
        assert np.abs(got.astype(int) - want).max() <= 1


@pytest.mark.cuda
def test_traced_cell_call_launches_no_layout_transpose_or_concatenation(
        card):
    up = ModelUpscaler(str(CELL_DIR))
    img = traffic.pool({"frame": [339, 510, 3], "pool": 1}, 2147483701)[0]
    up(img)
    before, convs, launches = _blocks(), _convs(), conv3x3_tc.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        up(img)
        torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(_blocks(), before)) == (3 * 23, 0)
    assert tuple(a - b for a, b in zip(_convs(), convs)) == (349, 2)
    assert conv3x3_tc.launches - launches == 349
    kernels = {e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA}
    assert any("fprop" in k or "conv" in k.lower() for k in kernels), kernels
    assert any("conv_implicit_gemm_kernel" in k for k in kernels), kernels
    banned = ("nhwcToNchw", "nchwToNhwc", "CatArrayBatchedCopy")
    assert not [k for k in kernels if any(b in k for b in banned)]
