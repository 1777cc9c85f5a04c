"""The port's checkpoint writer (bicubic_interpolation_model_tpu_torch/
train/checkpoint.py: ``save``, ``msgpack_pack``) against flax on the CPU:
``params.msgpack`` byte-equal to the JAX package's ``checkpoint.save``
(``flax.serialization.to_bytes`` of the tree as ``jax.device_get`` hands
it over, every map's keys sorted as strings) for the model families'
trees, ``meta.json`` byte-equal, each package loading the other's
checkpoints, and a port-written checkpoint served by both packages'
``ModelUpscaler`` within 2 u8 LSB."""

import pathlib

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
from flax import serialization

from bicubic_interpolation_model_tpu.models import espcn as jespcn
from bicubic_interpolation_model_tpu.models import esrgan as jesrgan
from bicubic_interpolation_model_tpu.models import mlp_predictor as jmlp
from bicubic_interpolation_model_tpu.models.weight_predictor import (
    init_params as jax_init_params)
from bicubic_interpolation_model_tpu.serving import (
    ModelUpscaler as JaxModelUpscaler)
from bicubic_interpolation_model_tpu.train import checkpoint as jax_ckpt
from bicubic_interpolation_model_tpu_torch.models.layers import (
    tree_from_jax, tree_to_numpy)
from bicubic_interpolation_model_tpu_torch.models.weight_predictor import (
    WeightPredictor)
from bicubic_interpolation_model_tpu_torch.serving import ModelUpscaler
from bicubic_interpolation_model_tpu_torch.train import checkpoint
from bicubic_interpolation_model_tpu_torch.train import trainer as tr

MODEL_DIR = pathlib.Path(__file__).resolve().parents[1] / "model"


KEY = jax.random.key(0)
X3 = jnp.zeros((1, 8, 8, 3))
TREES = {
    "weight_predictor": lambda: jax_init_params(KEY)[1],
    # 13 convs: Conv_10 .. Conv_12 sort before Conv_2
    "espcn_residual": lambda: jespcn.ESPCNResidual(
        features=8, n_blocks=5).init(KEY, X3),
    "esrgan": lambda: jesrgan.ESRGANLite(
        features=8, growth=4, n_blocks=2).init(KEY, X3),
    "pixel_mlp": lambda: jmlp.PixelMLP().init(KEY, jnp.zeros((1, 66))),
}


@pytest.mark.parametrize("name", ["weight_predictor", "espcn_residual",
                                  "esrgan", "pixel_mlp"])
def test_save_is_byte_equal_to_flax(tmp_path, name):
    tree = TREES[name]()
    meta = {"model": name, "scale": 4, "history": [{"epoch": 1,
                                                    "loss": 0.25}]}
    jax_ckpt.save(tmp_path / "jax", tree, meta=meta)
    # the port saves its own tensors; flax's bytes are of the same values
    checkpoint.save(tmp_path / "port", tree_from_jax(tree, device="cpu"),
                    meta=meta)
    flax_bytes = serialization.to_bytes(jax.device_get(tree))
    port_bytes = (tmp_path / "port" / "params.msgpack").read_bytes()
    assert port_bytes == flax_bytes
    assert port_bytes == (tmp_path / "jax" / "params.msgpack").read_bytes()
    assert (tmp_path / "port" / "meta.json").read_bytes() == (
        tmp_path / "jax" / "meta.json").read_bytes()
    if name == "espcn_residual":
        keys = list(msgpack.unpackb(port_bytes)["params"])
        assert keys.index("Conv_10") < keys.index("Conv_2")


@pytest.mark.parametrize("value", [
    0, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32, 2 ** 63,
    -1, -32, -33, -128, -129, -2 ** 15 - 1, -2 ** 31 - 1, -2 ** 63, 0.1,
    None, True, False, "a" * 31, "b" * 32, "c" * 300, "d" * 70000,
    b"x" * 3, b"y" * 300, b"z" * 70000, [1] * 15, [1] * 16,
    list(range(70000)), {str(i): i for i in range(15)},
    {str(i): [i, "v"] for i in range(70000)}])
def test_msgpack_pack_is_msgpack_packb(value):
    """Every header and integer in its smallest form, as msgpack-python
    writes it."""
    assert checkpoint.msgpack_pack(value) == msgpack.packb(value,
                                                           use_bin_type=True)


@pytest.mark.parametrize("shape", [(), (1,), (2,), (4,), (3, 3, 4, 32),
                                   (70000,)])
def test_array_leaves_are_flax_ext_types(shape):
    """ndarray leaves as flax's packer writes them: ext type 1, in an ext
    header of the payload's size."""
    a = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    tree = {"params": {"k": a}}
    assert checkpoint.msgpack_pack(tree) == \
        serialization.msgpack_serialize(tree)
    back = checkpoint.msgpack_unpack(checkpoint.msgpack_pack({"k": a}))
    np.testing.assert_array_equal(back["k"], a)


@pytest.mark.parametrize("name", ["wp-1e-3-120", "espcn_thick",
                                  "esrgan_lite", "pixel-mlp"])
def test_committed_checkpoints_rewrite_byte_equal(tmp_path, name):
    """A committed checkpoint (written by the JAX package) read by the port
    and saved again is the same file."""
    tree, meta = checkpoint.load(MODEL_DIR / name)
    checkpoint.save(tmp_path, tree, meta=meta)
    assert (tmp_path / "params.msgpack").read_bytes() == (
        MODEL_DIR / name / "params.msgpack").read_bytes()


def test_each_package_loads_the_others_checkpoints(tmp_path):
    template = TREES["weight_predictor"]()
    port_tree = tr.fresh_params(WeightPredictor(), "cpu", 5)
    checkpoint.save(tmp_path / "port", port_tree, meta={"model":
                                                        "WeightPredictor"})
    jtree, jmeta = jax_ckpt.load(tmp_path / "port", template)
    assert jmeta == {"model": "WeightPredictor"}
    jax.tree.map(np.testing.assert_array_equal, jax.device_get(jtree),
                 tree_to_numpy(port_tree))
    jax_ckpt.save(tmp_path / "jax", template, meta={"scale": 4})
    ptree, pmeta = checkpoint.load(tmp_path / "jax")
    assert pmeta == {"scale": 4}
    jax.tree.map(np.testing.assert_array_equal, ptree,
                 jax.device_get(template))


def test_port_written_checkpoint_serves_in_both_packages(tmp_path):
    """A checkpoint trained and saved by the port serves through both
    packages' ModelUpscaler within 2 u8 LSB."""
    rng = np.random.default_rng(6)
    data = {"a": {"X": rng.random((24, 24, 4), np.float32)}}
    trainer = tr.WeightPredictorTrainer(
        WeightPredictor(), tr.TrainConfig(patch_lr=8, batch_size=2),
        device="cpu")
    params = trainer.fit(data, epochs=2, log=lambda *_: None)
    checkpoint.save(tmp_path, params, meta={"model": "WeightPredictor",
                                            "scale": 4})
    frame = rng.integers(0, 256, (20, 28, 4), dtype=np.uint8)
    frame[..., 3] = 255
    port = ModelUpscaler(str(tmp_path), device="cpu")(frame)
    ref = np.asarray(JaxModelUpscaler(str(tmp_path))(frame))
    assert port.shape == ref.shape == (80, 112, 4)
    d = np.abs(port.astype(np.int64) - ref.astype(np.int64))
    assert int(d.max()) <= 2
    assert float(port.std()) > 0
    served = ModelUpscaler(str(tmp_path), device="cpu").params
    jax.tree.map(np.testing.assert_array_equal, tree_to_numpy(served),
                 tree_to_numpy(params))
