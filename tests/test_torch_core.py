"""The port's own copies of core/kernels.py and core/plan.py
(bicubic_interpolation_model_tpu_torch/core) against the JAX package's.

Tolerance: none. Both are NumPy on the host, so every kernel value, plan
index (int32) and plan weight (float32) must be equal bit for bit:
everything downstream inherits the plan's clamp semantics."""

import numpy as np
import pytest

from bicubic_interpolation_model_tpu.core import kernels as jk
from bicubic_interpolation_model_tpu.core import plan as jp
from bicubic_interpolation_model_tpu_torch.core import kernels as tk
from bicubic_interpolation_model_tpu_torch.core import plan as tp

SCALES = [2, 4, 1.5, 2.5, 1.25]
SIZES = [1, 2, 3, 7, 16, 37]
METHODS = ["nearest", "bilinear", "bicubic", "lanczos"]


def _same_plan(a, b):
    assert a.idx.dtype == b.idx.dtype == np.int32
    assert a.w.dtype == b.w.dtype == np.float32
    assert (a.n_in, a.n_out, a.scale, a.taps) == (b.n_in, b.n_out, b.scale,
                                                  b.taps)
    np.testing.assert_array_equal(a.idx, b.idx)
    assert a.w.tobytes() == b.w.tobytes()


@pytest.mark.parametrize("name,kw", [
    ("cubic_keys", {}), ("cubic_keys", {"a": -0.75}), ("lanczos", {}),
    ("lanczos", {"a": 2}), ("bilinear_hat", {})])
def test_kernel_functions_bit_equal(name, kw):
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(-4, 4, 500),
                        np.arange(-4, 5) * 1.0, np.arange(-8, 9) * 0.5])
    want = getattr(jk, name)(x, **kw)
    got = getattr(tk, name)(x, **kw)
    assert got.dtype == np.float64 and got.tobytes() == want.tobytes()


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("scale", SCALES)
def test_plan_axis_bit_equal(method, scale):
    for n_in in SIZES:
        _same_plan(tp.plan_axis(method, n_in, float(scale)),
                   jp.plan_axis(method, n_in, float(scale)))


def test_plan_parameters_and_n_out_override():
    _same_plan(tp.plan_bicubic(9, 4.0, a=-0.75), jp.plan_bicubic(9, 4.0,
                                                                 a=-0.75))
    _same_plan(tp.plan_lanczos(9, 3.0, a=2), jp.plan_lanczos(9, 3.0, a=2))
    _same_plan(tp.plan_bilinear(5, 2.5, n_out=11),
               jp.plan_bilinear(5, 2.5, n_out=11))
    _same_plan(tp.plan_nearest(3, 1.5, n_out=4), jp.plan_nearest(3, 1.5,
                                                                 n_out=4))
    for n, s in [(1, 2), (7, 2.5), (640, 4)]:
        assert tp.out_size(n, s) == jp.out_size(n, s)


def test_plan_axis_rejects_unknown_method():
    with pytest.raises(ValueError, match="unknown method"):
        tp.plan_axis("adaptive", 8, 2.0)


@pytest.mark.parametrize("method", METHODS)
def test_plan_to_matrix_bit_equal(method):
    a, b = tp.plan_axis(method, 11, 2.5), jp.plan_axis(method, 11, 2.5)
    ma, mb = tp.plan_to_matrix(a), jp.plan_to_matrix(b)
    assert ma.dtype == np.float32 and ma.tobytes() == mb.tobytes()


@pytest.mark.parametrize("method", ["box", "triangle", "cubic", "bicubic",
                                    "lanczos2", "lanczos3"])
def test_plan_downsample_bit_equal(method):
    for n_in, factor in [(32, 4), (17, 2), (40, 2.5)]:
        _same_plan(tp.plan_downsample(n_in, factor, method),
                   jp.plan_downsample(n_in, factor, method))
    with pytest.raises(ValueError, match="factor"):
        tp.plan_downsample(8, 0.5)


def test_phase_lut_and_interior_band_equal():
    for s in (2, 3, 4):
        assert (tp.phase_lut_bicubic(s).tobytes()
                == jp.phase_lut_bicubic(s).tobytes())
        assert tp.interior_band(20, s) == jp.interior_band(20, s)
