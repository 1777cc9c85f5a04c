"""The port's checkpoint reader (bicubic_interpolation_model_tpu_torch/train/
checkpoint.py) against flax's msgpack restore, and ``params_from_jax``.

Tolerance: bit-equal everywhere (a reader reproduces bytes)."""

import json
import math
import pathlib

import msgpack
import numpy as np
import pytest
import torch
from flax import serialization

from bicubic_interpolation_model_tpu.evaluation.model_analysis import (
    _load_model_any as jax_load_model_any)
from bicubic_interpolation_model_tpu_torch.models.weight_predictor import (
    LAYERS, params_from_jax)
from bicubic_interpolation_model_tpu_torch.train.checkpoint import (
    load, msgpack_unpack)

MODEL_DIR = pathlib.Path(__file__).resolve().parents[1] / "model"
CHECKPOINTS = sorted(p.parent.name for p in MODEL_DIR.glob("*/params.msgpack"))


def _assert_same_tree(a, b, path="") -> int:
    """Bit-equal trees; returns the number of array leaves."""
    if isinstance(b, dict):
        assert isinstance(a, dict) and list(a) == list(b), path
        return sum(_assert_same_tree(a[k], b[k], f"{path}/{k}") for k in b)
    if isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray), path
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path
        return 1
    assert type(a) is type(b) and a == b, path
    return 0


def test_all_nine_checkpoints_present():
    assert len(CHECKPOINTS) == 9


@pytest.mark.parametrize("name", CHECKPOINTS)
def test_msgpack_reader_matches_flax(name):
    raw = (MODEL_DIR / name / "params.msgpack").read_bytes()
    n_leaves = _assert_same_tree(msgpack_unpack(raw),
                                 serialization.msgpack_restore(raw))
    assert n_leaves > 0


@pytest.mark.parametrize("obj", [
    0, 127, -1, -32, 128, 255, 256, 65535, 65536, 2 ** 32, 2 ** 63,
    -33, -129, -32769, -2 ** 31 - 1, -2 ** 63, 1.5, -0.25, math.pi,
    None, True, False, "", "x" * 31, "é" * 40, "y" * 300, "z" * 70000,
    b"", b"\x00" * 300, b"\x01" * 70000, [1, [2, [3]]], list(range(20)),
    {"a": {"b": [1, 2]}}, {str(i): i for i in range(20)},
])
def test_msgpack_scalar_and_container_types(obj):
    """Every type byte the decoder takes, vs the msgpack package."""
    raw = msgpack.packb(obj, use_bin_type=True)
    assert msgpack_unpack(raw) == msgpack.unpackb(raw, raw=False)


def test_msgpack_float32():
    raw = msgpack.packb(0.1, use_single_float=True)
    assert msgpack_unpack(raw) == msgpack.unpackb(raw)


@pytest.mark.parametrize("n", [3, 200, 40000])     # ext8 / ext16 / ext32
def test_msgpack_ndarray_ext(n):
    arr = np.arange(n, dtype=np.int16)
    payload = msgpack.packb((arr.shape, arr.dtype.name, arr.tobytes()),
                            use_bin_type=True)
    got = msgpack_unpack(msgpack.packb(msgpack.ExtType(1, payload)))
    assert got.dtype == arr.dtype and got.shape == arr.shape
    assert (got == arr).all()


def test_msgpack_rejects_unknown_ext():
    with pytest.raises(ValueError):               # fixext4, code 9
        msgpack_unpack(msgpack.packb(msgpack.ExtType(9, b"abcd")))


def test_msgpack_rejects_truncated_and_trailing():
    raw = msgpack.packb({"a": [1, 2, 3]})
    with pytest.raises(ValueError):
        msgpack_unpack(raw[:-1])
    with pytest.raises(ValueError):
        msgpack_unpack(raw + b"\x00")


def test_load_returns_tree_and_meta():
    tree, meta = load(MODEL_DIR / "wp-1e-3-120")
    assert meta == json.loads((MODEL_DIR / "wp-1e-3-120" /
                               "meta.json").read_text())
    assert set(tree["params"]) == set(LAYERS)
    assert tree["params"]["upsample"]["kernel"].shape == (4, 4, 16, 32)


@pytest.mark.parametrize("name", ["wp-1e-3-120", "wp-adaptive-1e-3-120"])
def test_params_from_jax_carries_flax_params(name):
    """The flax tree loaded through the JAX package becomes the port's
    tensors bit for bit, equal to the port's own load."""
    _, jparams = jax_load_model_any(str(MODEL_DIR / name))
    jp = {k: {kk: np.asarray(vv) for kk, vv in v.items()}
          for k, v in jparams["params"].items()}
    got = params_from_jax(jparams, device="cpu")["params"]
    own = params_from_jax(load(MODEL_DIR / name)[0], device="cpu")["params"]
    for layer in LAYERS:
        for k in ("kernel", "bias"):
            t = got[layer][k]
            assert t.dtype == torch.float32 and t.device.type == "cpu"
            assert t.numpy().tobytes() == jp[layer][k].astype(
                np.float32).tobytes()
            assert torch.equal(t, own[layer][k])


def test_params_from_jax_rejects_other_trees():
    with pytest.raises(ValueError):
        params_from_jax({"params": {"conv_in": {}}}, device="cpu")
