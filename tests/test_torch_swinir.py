"""SwinIR's published real-world x4 model (``models/swinir.SwinIR``,
MODEL_ZOO ``swinir_realsr_x4``) on the port's direct path, against the
benchmark's plain reference (``benchmark/reference/swinir.py``, plain
torch, its own NumPy draw of the seeded weights), on the CPU; the window
attention kernel and a cell frame on the card.

The CPU tests run a small SwinIR (2 RSTBs of 2 blocks, 24 features, 2
heads of 12, window 8, 16 features in the upsampler) on a 19x21 frame,
padded to 24x24, so that the reflect padding, the shift and its mask all
occur. Tolerances:

- float64 before rounding: ≤1e-10 in [0, 1] units. Both sides compute the
  same equations in float64 from the same float32 weights, the port on
  tokens in unshifted order, the reference on rolled windows; the sums
  differ in order only (~1e-16 relative each).
- float32 bytes against float64 bytes: ≤1 u8, a share of differing bytes
  ≤1e-3, the configuration's ``limits.mismatch_share``. A byte differs
  only where the float64 value lies within the float32 error (~1e-6
  relative) of a rounding edge; one TF32 pass (~1e-3) moves a share of
  several percent (the benchmark's control, ``benchmark/tests``).
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import pathlib
import sys
import weakref

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark import traffic  # noqa: E402
from benchmark.reference import swinir as ref  # noqa: E402
from benchmark.reference import tf32_round  # noqa: E402
from bicubic_interpolation_model_tpu_torch.models import (  # noqa: E402
    esrgan, inference, swinir, upsample)
from bicubic_interpolation_model_tpu_torch.models.layers import (  # noqa: E402
    empty_module)
from bicubic_interpolation_model_tpu_torch.models.zoo import (  # noqa: E402
    MODEL_ZOO, load_model)
from bicubic_interpolation_model_tpu_torch.ops import (  # noqa: E402
    linear_tc, window_attention as wa)
from bicubic_interpolation_model_tpu_torch.serving import (  # noqa: E402
    ModelUpscaler)

CELL_DIR = ROOT / "benchmark" / "configs" / "swinir-m-realsr-x4"
CELL_META = json.loads((CELL_DIR / "meta.json").read_text())
SMALL = {"embed": 24, "depths": [2, 2], "heads": [2, 2], "features": 16}
LIMIT = 1e-3             # the configuration's limits.mismatch_share
FRAME = (19, 21)


def _ckpt(path, **meta):
    path.mkdir(parents=True, exist_ok=True)
    (path / "meta.json").write_text(json.dumps(
        {"model": "swinir_realsr_x4", **SMALL, **meta}))
    return path


@pytest.fixture(scope="module")
def small_dir(tmp_path_factory):
    return _ckpt(tmp_path_factory.mktemp("swinir_small"),
                 init=CELL_META["init"])


@pytest.fixture(scope="module")
def small(small_dir):
    model, params = load_model(small_dir, device="cpu")
    return model, params, ref.load(small_dir, "cpu")


def _frame(h, w, c=3, seed=5):
    return traffic.frame(traffic.rng_for(seed, 0), h, w, c)


def _port_float64(model, params, img):
    x = torch.as_tensor(img[..., :3])[None].to(torch.float64) / 255.0
    return inference._apply_direct(model, params, x, torch.float64)[0]


def _port_bytes(model, params, img):
    return inference.super_resolve_direct(model, params, img).numpy()


# -- float64: the port's equations are the reference's -------------------

def test_float64_port_matches_reference_before_rounding(small):
    model, params, state = small
    img = _frame(*FRAME)
    got = _port_float64(model, params, img)
    want = ref.upscale_float(state, torch.as_tensor(img))
    assert got.shape == want.shape == (76, 84, 3)
    assert float((got - want).abs().max()) <= 1e-10
    assert float(want.std()) > 0.03          # not a constant output


def test_f32_bytes_within_one_of_float64(small):
    model, params, state = small
    for seed in (5, 6):
        img = _frame(*FRAME, seed=seed)
        got = _port_bytes(model, params, img)
        want = ref.run(state, torch.as_tensor(img)).numpy()
        assert got.shape == want.shape and got.dtype == np.uint8
        d = np.abs(got.astype(int) - want)
        assert d.max() <= 1 and float((d > 0).mean()) <= LIMIT


# -- the attention alone ---------------------------------------------------

@pytest.mark.parametrize("shift", [0, 4])
def test_plain_window_attention_matches_the_references(shift):
    """The port's plain window attention (and its wrapper on the CPU) on
    tokens in unshifted order against the reference's published
    ``WindowAttention`` on rolled, partitioned windows, with ``proj`` the
    identity so that the attention itself is compared, in float64."""
    hp, wp, c, heads = 16, 24, 24, 2
    rng = np.random.default_rng(31 + shift)
    t = torch.tensor(rng.standard_normal((hp * wp, c)))
    w_qkv = torch.tensor(rng.standard_normal((3 * c, c)) / np.sqrt(c) * 2)
    b_qkv = torch.tensor(rng.standard_normal(3 * c) * 0.1)
    table = torch.tensor(rng.standard_normal((225, heads)))
    blk = "b"
    state = {"weights": {
        f"{blk}.attn.qkv.weight": w_qkv, f"{blk}.attn.qkv.bias": b_qkv,
        f"{blk}.attn.proj.weight": torch.eye(c, dtype=torch.float64),
        f"{blk}.attn.proj.bias": torch.zeros(c, dtype=torch.float64),
        f"{blk}.attn.relative_position_bias_table": table}}
    y = t.view(1, hp, wp, c)
    if shift:
        y = torch.roll(y, (-shift, -shift), (1, 2))
    win = ref._partition(y, 8).view(-1, 64, c)
    mask = ref.attn_mask(hp, wp, 8, shift) if shift else None
    a = ref._attention(state, blk, win, heads, mask, "float64")
    want = ref._reverse(a.view(-1, 8, 8, c), 8, hp, wp)
    if shift:
        want = torch.roll(want, (shift, shift), (1, 2))
    want = want.reshape(hp * wp, c)
    qkv = t @ w_qkv.T + b_qkv
    bias = wa.relative_bias(table)
    scale = (c // heads) ** -0.5
    got = wa.window_attention_reference(qkv, bias, hp, wp, heads, shift,
                                        scale)
    assert float((got - want).abs().max()) <= 1e-12
    assert torch.equal(wa.window_attention(qkv, bias, hp, wp, heads, shift,
                                           scale), got)
    if shift:
        assert torch.equal(wa.shift_mask(hp, wp, shift, 8,
                                          dtype=torch.float64),
                           ref.attn_mask(hp, wp, 8, shift).double())


def test_relative_bias_is_the_published_gather_kept_on_the_table():
    table = torch.randn(225, 3)
    bias = wa.relative_bias(table)
    idx = ref.relative_position_index(8)
    assert torch.equal(wa.relative_position_index(8), idx)
    assert torch.equal(bias, table[idx.view(-1)].view(64, 64, 3)
                       .permute(2, 0, 1))
    assert wa.relative_bias(table) is bias
    table.mul_(2.0)                       # changed in place: built again
    assert torch.equal(wa.relative_bias(table), 2 * bias)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    qkv = torch.zeros(16 * 16, 3 * 24)
    bias = torch.zeros(2, 64, 64)
    with pytest.raises(ValueError, match="grid"):
        wa.window_attention(qkv[:-16], bias, 15, 16, 2, 0, 0.2)
    with pytest.raises(ValueError, match="head dim"):
        wa.window_attention(qkv, torch.zeros(5, 64, 64), 16, 16, 5, 0, 0.2)
    with pytest.raises(ValueError, match="shift"):
        wa.window_attention(qkv, bias, 16, 16, 2, 8, 0.2)
    with pytest.raises(ValueError, match="bias"):
        wa.window_attention(qkv, bias.double(), 16, 16, 2, 0, 0.2)
    with pytest.raises(ValueError, match="float32 on the card"):
        wa.window_attention(qkv.int(), bias, 16, 16, 2, 0, 0.2)


# -- ablations: the reference without a part of the mathematics fails -----

def _ablated(state, monkeypatch, what):
    if what == "bias":
        state = {**state, "weights": {
            k: torch.zeros_like(v) if k.endswith("bias_table") else v
            for k, v in state["weights"].items()}}
    elif what == "mask":
        monkeypatch.setattr(ref, "attn_mask", lambda hp, wp, window, shift:
                            torch.zeros((hp * wp // window ** 2,
                                         window ** 2, window ** 2)))
    else:
        block = ref._block
        monkeypatch.setattr(ref, "_block", lambda st, b, t, hp, wp, heads,
                            shift, precision: block(st, b, t, hp, wp, heads,
                                                    0, precision))
    return state


@pytest.mark.parametrize("what", ["bias", "mask", "shift"])
def test_reference_without_bias_mask_or_shift_fails_the_tolerances(
        what, small, monkeypatch):
    model, params, state = small
    img = _frame(*FRAME)
    got = _port_float64(model, params, img)
    got_u8 = _port_bytes(model, params, img)
    ablated = _ablated(state, monkeypatch, what)
    want = ref.upscale_float(ablated, torch.as_tensor(img))
    assert float((got - want).abs().max()) > 1e-3
    d = np.abs(got_u8.astype(int) -
               ref.run(ablated, torch.as_tensor(img)).numpy())
    assert d.max() > 1 or float((d > 0).mean()) > LIMIT


# -- weights: the seeded init and the published state dicts --------------

def test_published_widths_and_parameter_count():
    model = empty_module(lambda: MODEL_ZOO["swinir_realsr_x4"](), "cpu")
    assert isinstance(model, swinir.SwinIR)
    assert (model.embed, model.depths, model.heads, model.features) == (
        180, (6,) * 6, (6,) * 6, 64)
    assert sum(p.numel() for p in model.parameters()) == 11_715_559
    params = swinir.published_params()
    assert sum(int(np.prod(s)) for _, _, s, _ in params) == 11_715_559
    assert [n for n, *_ in params[:6]] == [
        "conv_first.weight", "conv_first.bias", "patch_embed.norm.weight",
        "patch_embed.norm.bias", "layers.0.residual_group.blocks.0.norm1."
        "weight", "layers.0.residual_group.blocks.0.norm1.bias"]
    assert params[6][0] == ("layers.0.residual_group.blocks.0.attn."
                            "relative_position_bias_table")
    assert params[-1][0] == "conv_last.bias"
    with pytest.raises(ValueError, match="4x only, not 2x"):
        MODEL_ZOO["swinir_realsr_x4"](scale=2)


def test_seeded_loader_gives_the_reference_tensors_bit_for_bit():
    init = CELL_META["init"]
    sd = swinir.seeded_state_dict(init)
    drawn = ref.draw(init, ref.dims_of(CELL_META))
    assert list(sd) == list(drawn)
    for name, v in drawn.items():
        assert sd[name].dtype == np.float32 and np.array_equal(sd[name], v)
    assert [n for n, *_ in swinir.published_params()] == [
        n for n, *_ in ref.params(**ref.dims_of(CELL_META))]


def test_seeded_init_that_states_another_draw_raises():
    init = dict(CELL_META["init"], std="another std")
    with pytest.raises(ValueError, match="another draw"):
        swinir.seeded_state_dict(init, **SMALL)
    with pytest.raises(ValueError, match="another draw"):
        swinir.seeded_state_dict({**CELL_META["init"], "extra": 1}, **SMALL)
    with pytest.raises(ValueError, match="does not make"):
        ref.draw(init, SMALL)


def _trees_equal(a, b):
    if isinstance(a, dict):
        return set(a) == set(b) and all(_trees_equal(a[k], b[k]) for k in a)
    return torch.equal(a, b)


def _published_sd(with_buffers=True):
    """The small model's seeded state dict as a published checkpoint holds
    it: torch tensors, with the buffers the published module registers."""
    sd = {k: torch.from_numpy(v) for k, v in
          swinir.seeded_state_dict(CELL_META["init"], **SMALL).items()}
    if with_buffers:
        for i, depth in enumerate(SMALL["depths"]):
            for j in range(depth):
                b = f"layers.{i}.residual_group.blocks.{j}"
                sd[f"{b}.attn.relative_position_index"] = \
                    ref.relative_position_index(8)
                if j % 2:
                    sd[f"{b}.attn_mask"] = ref.attn_mask(64, 64, 8, 4)
    return sd


@pytest.mark.parametrize("wrapper", [None, "params_ema", "params"])
def test_published_state_dicts_load_to_the_seeded_tree(wrapper, small,
                                                       tmp_path):
    _, params, _ = small
    sd = _published_sd()
    torch.save(sd if wrapper is None else {wrapper: sd},
               tmp_path / "w.pth")
    _ckpt(tmp_path, state_dict="w.pth")
    model, got = load_model(tmp_path, device="cpu")
    assert isinstance(model, swinir.SwinIR)
    assert _trees_equal(got, params)


@pytest.mark.parametrize("kind,match", [("missing", "missing"),
                                        ("extra", "extra"),
                                        ("shape", "shape")])
def test_bad_state_dict_raises(kind, match):
    sd = _published_sd()
    if kind == "missing":
        del sd["layers.1.residual_group.blocks.1.mlp.fc2.bias"]
    elif kind == "extra":
        sd["layers.2.conv.weight"] = torch.zeros(24, 24, 3, 3)
    else:
        sd["conv_up1.weight"] = torch.zeros(16, 16, 1, 1)
    with pytest.raises(ValueError, match=match):
        swinir.tree_from_state_dict(sd, **SMALL)


def test_meta_without_weights_raises(tmp_path):
    with pytest.raises(ValueError, match="neither"):
        swinir.load_swinir(tmp_path, {"model": "swinir_realsr_x4"},
                           device="cpu")


# -- the served path ------------------------------------------------------

@pytest.mark.parametrize("entry", ["__call__", "batch", "stream"])
@pytest.mark.parametrize("channels", [3, 4])
def test_model_upscaler_serves_rgb_out(entry, channels, small_dir, small):
    up = ModelUpscaler(str(small_dir), device="cpu")
    frames = np.stack([_frame(9, 11, channels, seed=s) for s in (1, 2, 3)])
    if entry == "__call__":
        outs = [up(f) for f in frames]
    elif entry == "batch":
        outs = list(up.batch(frames))
    else:
        outs = list(up.stream(iter(frames), microbatch=2))
    state = small[2]
    for f, out in zip(frames, outs):
        assert out.shape == (36, 44, 3) and out.dtype == np.uint8
        want = ref.run(state, torch.as_tensor(f)).numpy()
        assert np.abs(out.astype(int) - want).max() <= 1
        assert np.array_equal(up(np.ascontiguousarray(f[..., :3])), up(f))


def _counts():
    s = swinir.SwinIR
    return (s.attention_kernel_blocks, s.plain_attention_blocks,
            s.conv3x3_convs, s.cudnn_convs)


def test_counters_read_each_route_a_frame(small):
    """With grad off every block's attention goes through the kernel's
    wrapper (its plain version on the CPU), the HR stage's three convs
    through the conv kernel's; conv_first, the RSTB convs, conv_after_body,
    conv_before_upsample and conv_last are cuDNN's. With grad on, the
    plain attention (the kernel has no backward)."""
    model, params, _ = small
    blocks = sum(SMALL["depths"])
    before = _counts()
    _port_bytes(model, params, _frame(*FRAME))
    assert tuple(a - b for a, b in zip(_counts(), before)) == (
        blocks, 0, 3, len(SMALL["depths"]) + 4)
    x = torch.as_tensor(_frame(*FRAME))[None].float() / 255.0
    before = _counts()
    with torch.enable_grad():
        model.apply(params, x).square().mean().backward()
    assert tuple(a - b for a, b in zip(_counts(), before))[:2] == (0,
                                                                   blocks)
    table = params["params"]["RSTB_1"]["Block_1"]["rel_bias"]["table"]
    assert table.grad is not None and float(table.grad.abs().max()) > 0


def _linear_counts():
    s = swinir.SwinIR
    return (s.linear_kernel_calls, s.plain_linear_calls,
            linear_tc.linear_tc.launches)


def test_linears_of_a_frame_run_plain_on_the_cpu(small):
    """Four linears a block (qkv, proj with its residual, fc1 with GELU,
    fc2 with its residual): 16 for the small model's 4 blocks, each on the
    plain version on the CPU, with grad off and on; nothing launched."""
    model, params, _ = small
    blocks = sum(SMALL["depths"])
    before = _linear_counts()
    _port_bytes(model, params, _frame(*FRAME))
    assert tuple(a - b for a, b in zip(_linear_counts(), before)) == (
        0, 4 * blocks, 0)
    x = torch.as_tensor(_frame(*FRAME))[None].float() / 255.0
    before = _linear_counts()
    with torch.enable_grad():
        model.apply(params, x).square().mean().backward()
    assert tuple(a - b for a, b in zip(_linear_counts(), before)) == (
        0, 4 * blocks, 0)
    fc2 = params["params"]["RSTB_0"]["Block_1"]["fc2"]["kernel"]
    assert fc2.grad is not None and float(fc2.grad.abs().max()) > 0


def test_blocks_of_a_frame_and_the_esrgan_counters_stay_apart(small):
    model, params, _ = small
    before = (esrgan.RRDBNet.conv3x3_convs, esrgan.RRDBNet.cudnn_convs)
    _port_bytes(model, params, _frame(9, 11))
    assert (esrgan.RRDBNet.conv3x3_convs,
            esrgan.RRDBNet.cudnn_convs) == before


def test_batch_of_two_gives_the_frames_of_two_single_calls(small):
    model, params, _ = small
    frames = np.stack([_frame(9, 11, seed=s) for s in (3, 4)])
    batch = inference.super_resolve_batch(model, params, frames).numpy()
    for f, out in zip(frames, batch):
        assert np.array_equal(out, _port_bytes(model, params, f))


def _small_esrgan(path):
    """A small seeded published ESRGAN generator (2 RRDBs, 16 features,
    growth 8) on the CPU."""
    init = {"rng": esrgan.INIT_RNG, "seed": 7, "order": esrgan.INIT_ORDER,
            "kernel": esrgan.INIT_KERNEL,
            "scale": {"body": 0.1, "conv_first": 1.0, "conv_body": 0.1,
                      "conv_up1": 1.0, "conv_up2": 1.0, "conv_hr": 1.0,
                      "conv_last": 0.5},
            "bias": {"conv_last": [0.5, 0.5, 0.5]}}
    (path / "meta.json").write_text(json.dumps(
        {"model": "esrgan_x4", "scale": 4, "n_blocks": 2, "features": 16,
         "growth": 8, "init": init}))
    return load_model(path, device="cpu")


def test_esrgan_hr_stage_output_is_unchanged_byte_for_byte(tmp_path):
    """The published ESRGAN generator, whose HR stage now is
    ``upsample.nearest_conv_x4`` (shared with SwinIR): its float32 CPU
    output on a small seeded RRDBNet is the bytes the code before the
    shared stage gave."""
    model, params = _small_esrgan(tmp_path)
    img = _frame(13, 17)
    x = torch.as_tensor(img)[None].float() / 255.0
    with torch.no_grad():
        y = model.apply(params, x)
    assert y.shape == (1, 52, 68, 3)
    assert y[0, 0, 0].tolist() == [0.45865997672080994, 0.72314453125,
                                   0.6107027530670166]
    assert y[0, 51, 67].tolist() == [0.7934008240699768, 0.5302262306213379,
                                     0.3903486728668213]
    assert hashlib.sha256(y.contiguous().numpy().tobytes()).hexdigest() == (
        "4a8de2be77ede11ab905a07856c727b89e940b7c448bf420dedd207b2269c3bc")
    u8 = inference.super_resolve_direct(model, params, img).numpy()
    assert hashlib.sha256(u8.tobytes()).hexdigest() == (
        "97fe8b529dee20520ca93489f9d2d8d777dda76a5678f5a031154d6921bff722")


@pytest.mark.parametrize("which", ["swinir", "esrgan"])
def test_hr_stage_frees_the_trunk_output_after_conv_up1(which, small,
                                                         tmp_path,
                                                         monkeypatch):
    """Both models hand their LR features to ``nearest_conv_x4`` as a
    temporary: nothing holds them once conv_up1 has read them (on the card
    they would otherwise sit beside the HR stage's 4x tensors)."""
    if which == "swinir":
        model, params, _ = small
        cls, trunk = swinir.SwinIR, "_features"
    else:
        model, params = _small_esrgan(tmp_path)
        cls, trunk = esrgan.RRDBNet, "_trunk_channel_major"
    refs, alive = [], []
    inner, conv = getattr(cls, trunk), upsample.conv_tc

    def traced_trunk(self, *args):
        out = inner(self, *args)
        refs.append(weakref.ref(out))
        return out

    def traced_conv(x, leaf, counts, **epilogue):
        alive.append(refs[-1]() is not None)
        return conv(x, leaf, counts, **epilogue)

    monkeypatch.setattr(cls, trunk, traced_trunk)
    monkeypatch.setattr(upsample, "conv_tc", traced_conv)
    x = torch.as_tensor(_frame(9, 11))[None].float() / 255.0
    with torch.no_grad():
        model.apply(params, x)
    assert alive == [True, False, False]      # conv_up1, conv_up2, conv_hr


# -- spans ----------------------------------------------------------------

def test_trunk_rstb_and_upsample_spans_nest_in_model_step(small_dir,
                                                          tmp_path):
    up = ModelUpscaler(str(small_dir), device="cpu")
    img = _frame(9, 11)
    up(img)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("__call__"):
            up(img)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                    e["name"])
                   for e in json.loads(path.read_text())["traceEvents"]
                   if e.get("ph") == "X"
                   and e.get("cat") == "user_annotation")
    named = {n: [s for s in spans if s[2] == n]
             for n in ("model.step", "model.trunk", "model.rstb",
                       "model.upsample")}
    assert [len(named[n]) for n in named] == [1, 1, len(SMALL["depths"]), 1]
    (s0, s1, _), = named["model.step"]
    (t0, t1, _), = named["model.trunk"]
    (u0, u1, _), = named["model.upsample"]
    assert s0 <= t0 <= t1 <= u0 <= u1 <= s1
    assert all(t0 <= r0 <= r1 <= t1 for r0, r1, _ in named["model.rstb"])


def test_span_split_script_runs_the_swinir_path_on_the_cpu(small_dir,
                                                           capsys):
    """The script's plumbing on the SwinIR path, served from the small
    seeded SwinIR (the published widths are the card's)."""
    path = ROOT / "scripts" / "torch_span_split.py"
    spec = importlib.util.spec_from_file_location("torch_span_split", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    module.MODELS["swinir"] = small_dir
    assert module.main(["--cpu", "--path", "swinir_div2k_call",
                        "--frames", "1"]) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["path"] == "swinir_div2k_call" and row["frame"][2] == 3
    assert {"model.step", "model.trunk", "model.rstb",
            "model.upsample"} <= set(row["spans"])
    assert row["spans"]["model.rstb"]["count"] == len(SMALL["depths"])
    assert row["attention_blocks"] == {"kernel": sum(SMALL["depths"]),
                                       "plain": 0}


# -- on the card -------------------------------------------------------------

@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the window attention kernel is "
                    "CUDA C++ with no CPU mode")
    return torch.device("cuda")


def _attention_case(hp, wp, seed, device, c=180, heads=6):
    """qkv of one block at the cell's scales: LN-normalised tokens through
    a qkv projection of std 2.2 a channel, a table of std 1."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    qkv = (torch.randn((hp * wp, 3 * c), generator=g) * 2.2).to(device)
    table = torch.randn((225, heads), generator=g).to(device)
    return qkv, wa.relative_bias(table), (c // heads) ** -0.5


def _tf32_plain(qkv, bias, hp, wp, heads, shift, scale):
    """The plain version with every product's operands rounded to TF32
    (one TF32 pass): the precision the kernel must beat."""
    c = qkv.shape[1] // 3
    hd = c // heads
    x = torch.roll(qkv.reshape(hp, wp, 3 * c), (-shift, -shift), (0, 1))
    x = x.reshape(hp // 8, 8, wp // 8, 8, 3, heads, hd)
    x = x.permute(4, 0, 2, 5, 1, 3, 6).reshape(3, -1, heads, 64, hd)
    q, k, v = tf32_round((x[0] * scale).contiguous()), tf32_round(
        x[1].contiguous()), tf32_round(x[2].contiguous())
    attn = q @ k.transpose(-2, -1) + bias
    if shift:
        attn = attn + wa.shift_mask(hp, wp, shift, device=qkv.device)[:,
                                                                      None]
    y = tf32_round(attn.softmax(-1).contiguous()) @ v
    y = y.reshape(hp // 8, wp // 8, heads, 8, 8, hd)
    y = y.permute(0, 3, 1, 4, 2, 5).reshape(hp, wp, c)
    return torch.roll(y, (shift, shift), (0, 1)).reshape(hp * wp, c)


#: the kernel's largest error against float64, as a share of the largest
#: output: 3xTF32 products (~2^-21 relative a term) and f32 softmax leave
#: ~1e-6; one TF32 pass (~2^-11 a term) ~1e-3, which this must refuse
KERNEL_TOL = 2e-5


@pytest.mark.cuda
@pytest.mark.parametrize("hp,wp", [(344, 512), (24, 40), (8, 8)])
@pytest.mark.parametrize("shift", [0, 4])
def test_kernel_matches_float64_at_the_published_widths_on_card(
        card, hp, wp, shift):
    qkv, bias, scale = _attention_case(hp, wp, hp + wp + shift, card)
    before = (wa.window_attention.launches, wa.window_attention.windows)
    got = wa.window_attention(qkv, bias, hp, wp, 6, shift, scale)
    torch.cuda.synchronize()
    assert (wa.window_attention.launches - before[0],
            wa.window_attention.windows - before[1]) == (1, hp * wp // 64)
    want = wa.window_attention_reference(qkv.double(), bias.double(), hp,
                                         wp, 6, shift, scale)
    top = float(want.abs().max())
    err = float((got.double() - want).abs().max()) / top
    tf32 = float((_tf32_plain(qkv, bias, hp, wp, 6, shift, scale).double()
                  - want).abs().max()) / top
    plain32 = float((wa.window_attention_reference(
        qkv, bias, hp, wp, 6, shift, scale).double() - want).abs().max()) \
        / top
    print(f"window_attention {hp}x{wp} shift {shift}: kernel {err:.3e}, "
          f"plain f32 {plain32:.3e}, one TF32 pass {tf32:.3e} of the "
          f"largest output {top:.3f}")
    assert err <= KERNEL_TOL < tf32


def _cell_frame(seed=2147483700):
    return traffic.pool({"frame": [339, 510, 3], "pool": 1}, seed)[0]


@pytest.mark.cuda
def test_served_cell_frame_within_one_of_float64_on_card(card):
    img = _cell_frame()
    got = ModelUpscaler(str(CELL_DIR))(img)
    want = ref.run(ref.load(CELL_DIR, card),
                   torch.as_tensor(img).to(card)).cpu().numpy()
    d = np.abs(got.astype(int) - want)
    assert got.shape == (1356, 2040, 3)
    share = float((d > 0).mean())
    inside = float(((want >= 1) & (want <= 254)).mean())
    print(f"cell frame: mismatch share {share:.3e}, bytes in 1..254 "
          f"{inside:.6f}, std {want.std():.2f} u8")
    assert d.max() <= 1 and share <= LIMIT
    assert inside >= 0.999 and want.std() >= 10


@pytest.mark.cuda
def test_traced_cell_frame_runs_every_block_on_the_kernel_on_card(card):
    """A cell frame: 36 launches of the attention kernel and no other
    route, 144 of the linear kernel and no plain linear, the HR stage's
    three convs on the conv kernel, ten cuDNN convs; no cuBLAS GEMM."""
    up = ModelUpscaler(str(CELL_DIR))
    img = _cell_frame(2147483701)
    up(img)
    before, launches = _counts(), wa.window_attention.launches
    linears = _linear_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        up(img)
        torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(_counts(), before)) == (36, 0, 3, 10)
    assert wa.window_attention.launches - launches == 36
    assert tuple(a - b for a, b in zip(_linear_counts(), linears)) == (
        144, 0, 144)
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert sum("window_attention_kernel" in n for n in names) == 36
    assert sum("conv_implicit_gemm_kernel" in n for n in names) == 3
    assert sum("linear_xmma_gemm_kernel" in n for n in names) == 144
    assert sum("xmma_gemm" in n for n in names) == 144


@pytest.mark.cuda
def test_kernel_block_writes_no_scores_on_card(card, monkeypatch):
    """One Swin block of the cell (RSTB 0, block 1, shifted) at 344x512:
    on the kernel its peak above its input is at least 250 MB below the
    plain attention's, which materialises [2752 x 6, 64, 64] f32 scores
    (270.5 MB) and more; both give the same tokens within f32 rounding."""
    model, params = load_model(CELL_DIR, device=card)
    blk = params["params"]["RSTB_0"]["Block_1"]
    g = torch.Generator(device="cpu").manual_seed(3)
    t = torch.randn((344 * 512, 180), generator=g).to(card)
    peaks, outs = [], []
    for plain in (False, True):
        if plain:
            monkeypatch.setattr(swinir, "serves", lambda x: False)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        with torch.no_grad():
            outs.append(model._block(blk, t, 344, 512, 6, 4))
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated() - base)
    print(f"block peak above its input: kernel {peaks[0] / 1e6:.1f} MB, "
          f"plain attention {peaks[1] / 1e6:.1f} MB")
    assert peaks[1] - peaks[0] >= 250e6
    assert float((outs[0] - outs[1]).abs().max()) <= 1e-3 * float(
        outs[1].abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16])
def test_other_precisions_take_the_plain_attention_on_card(card, small_dir,
                                                           dtype):
    """float64 and bfloat16 frames on the card (the kernels take float32
    alone) run every block's attention and linears plain, each block
    counted in ``plain_attention_blocks`` and each linear in
    ``plain_linear_calls``, none launched; float64 within one byte of the
    CPU's float64, bfloat16 within 4 u8 of it (bf16 keeps 8 bits of
    mantissa; 2 u8 read on an H100)."""
    model, params = load_model(small_dir, device=card)
    img = _frame(*FRAME)
    before, launches = _counts(), wa.window_attention.launches
    linears = _linear_counts()
    got = inference.super_resolve_direct(model, params, img,
                                         compute_dtype=dtype)
    assert tuple(a - b for a, b in zip(_counts(), before))[:2] == (
        0, sum(SMALL["depths"]))
    assert wa.window_attention.launches == launches
    assert tuple(a - b for a, b in zip(_linear_counts(), linears)) == (
        0, 4 * sum(SMALL["depths"]), 0)
    cpu_model, cpu_params = load_model(small_dir, device="cpu")
    want = inference.super_resolve_direct(cpu_model, cpu_params, img,
                                          compute_dtype=torch.float64)
    d = np.abs(got.cpu().numpy().astype(int) - want.numpy())
    print(f"{dtype} on the card against float64 on the CPU: largest "
          f"{d.max()} u8, share {float((d > 0).mean()):.3e}")
    assert d.max() <= (1 if dtype == torch.float64 else 4)
