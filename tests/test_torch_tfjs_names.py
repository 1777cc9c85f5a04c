"""The last two public names of the JAX package that the port lacked:
``models/tfjs_import.reference_model_names`` and ``ops/resize.Method``,
held equal to the JAX package's."""

import json

import pytest

from bicubic_interpolation_model_tpu.models import tfjs_import as jtfjs
from bicubic_interpolation_model_tpu.ops import resize as jresize
from bicubic_interpolation_model_tpu_torch.models import tfjs_import as ttfjs
from bicubic_interpolation_model_tpu_torch.ops import resize as tresize


def test_reference_model_names_list_the_checkpoint_directories(tmp_path):
    models = tmp_path / "model"
    for name, has_json in [("wp-1e-3-30", True), ("a-first", True),
                           ("no-manifest", False)]:
        (models / name).mkdir(parents=True)
        if has_json:
            (models / name / "model.json").write_text(json.dumps({}))
    (models / "stray.json").write_text("{}")
    got = ttfjs.reference_model_names(tmp_path)
    assert got == jtfjs.reference_model_names(tmp_path)
    assert got == ["a-first", "wp-1e-3-30"]
    assert ttfjs.reference_model_names(str(tmp_path)) == got


@pytest.mark.parametrize("root", ["missing", "no-model-dir"])
def test_reference_model_names_without_a_model_directory(tmp_path, root):
    path = tmp_path / root
    if root == "no-model-dir":
        path.mkdir()
    assert ttfjs.reference_model_names(path) == []
    assert jtfjs.reference_model_names(path) == []


def test_reference_model_names_default_root_is_the_jax_packages():
    assert ttfjs.reference_model_names() == jtfjs.reference_model_names()
    assert (ttfjs.reference_model_names.__defaults__
            == jtfjs.reference_model_names.__defaults__)


def test_method_names_the_four_classical_methods():
    assert tresize.Method.__args__ == jresize.Method.__args__
    assert tresize.Method.__args__ == ("nearest", "bilinear", "bicubic",
                                       "lanczos")
