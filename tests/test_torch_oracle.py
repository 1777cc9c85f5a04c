"""The port's own copy of core/oracle.py (bicubic_interpolation_model_tpu_torch
/core/oracle.py) against the JAX package's.

Tolerance: none. Both are float64 NumPy on the same plans, so every output
byte must be equal: the port's bench and chip_smoke hold the card's frames
to this oracle where the JAX package's is not installed."""

import zlib

import numpy as np
import pytest

from bicubic_interpolation_model_tpu.core import oracle as jo
from bicubic_interpolation_model_tpu_torch.core import oracle as to

METHODS = ("nearest", "bilinear", "bicubic", "lanczos")
SCALES = (2, 3, 4, 2.5)


def _frame(seed, h, w, c):
    """Flat on the left (constant), texture in the middle (±10 noise),
    edges on the right (uniform noise): all three adaptive region laws."""
    rng = np.random.default_rng(seed)
    img = np.full((h, w, c), 128, np.int64)
    img[:, w // 3:2 * w // 3] += rng.integers(-10, 11, (h, w // 3, c))
    img[:, 2 * w // 3:] = rng.integers(0, 256, (h, w - 2 * w // 3, c))
    img = img.astype(np.uint8)
    if c == 4:
        img[..., 3] = 255
    return img


def _cases():
    cases = []
    for m in METHODS:
        for s in SCALES:
            for c in (3, 4):
                cases.append(pytest.param("resize", m, s, c,
                                          id=f"resize-{m}-x{s}-c{c}"))
            cases.append(pytest.param("rows", m, s, 4, id=f"rows-{m}-x{s}"))
    for s in (2, 3, 4):
        for c in (3, 4):
            cases.append(pytest.param("adaptive", "adaptive", s, c,
                                      id=f"adaptive-x{s}-c{c}"))
    cases.append(pytest.param("adaptive", "adaptive", 2.5, 4,
                              id="adaptive-x2.5-c4"))
    for s in (2, 3, 4, 2.5):
        cases.append(pytest.param("adaptive_rows", "adaptive", s, 4,
                                  id=f"adaptive-rows-x{s}"))
    for s in (2, 3):
        cases.append(pytest.param("loops", "bicubic", s, 3,
                                  id=f"loops-x{s}"))
    cases.append(pytest.param("round", None, None, None, id="js_round_u8"))
    return cases


@pytest.mark.parametrize("kind,method,scale,c", _cases())
def test_port_oracle_byte_equal_to_jax_oracle(kind, method, scale, c):
    if kind == "round":
        # exact .5 values round half up (JS Math.round), then clamp
        v = np.concatenate([np.arange(-3, 259) + 0.5, np.arange(-3, 259),
                            [-1e9, 1e9, 254.4999999, 0.49999999]])
        got, want = to.js_round_u8(v), jo.js_round_u8(v)
        assert got.dtype == want.dtype == np.uint8
        assert got.tobytes() == want.tobytes()
        assert to.js_round_u8(np.array([0.5, 1.5, 2.5]))[:3].tolist() \
            == [1, 2, 3]
        return
    seed = zlib.crc32(f"{kind}-{method}-{scale}-{c}".encode())
    img = _frame(seed, 11, 15, c)
    if kind == "resize":
        got = to.resize_oracle(img, scale, method)
        want = jo.resize_oracle(img, scale, method)
    elif kind == "rows":
        n_rows = to.resize_oracle(img, scale, method).shape[0]
        rows = np.arange(0, n_rows, 3)
        got = to.resize_oracle_rows(img, scale, rows, method)
        want = jo.resize_oracle_rows(img, scale, rows, method)
        # the rows of the full oracle, too
        np.testing.assert_array_equal(
            got, to.resize_oracle(img, scale, method)[rows])
    elif kind == "adaptive":
        got = to.adaptive_bicubic_oracle(img, scale)
        want = jo.adaptive_bicubic_oracle(img, scale)
    elif kind == "adaptive_rows":
        # the port's rows alone equal those rows of the JAX full oracle
        full = jo.adaptive_bicubic_oracle(img, scale)
        rows = np.arange(1, full.shape[0], 4)
        got = to.adaptive_bicubic_oracle(img, scale, rows=rows)
        want = full[rows]
    else:
        img = img[:5, :6]
        got = to.resize_oracle_loops(img, scale)
        want = jo.resize_oracle_loops(img, scale)
        # the separable oracle agrees with the literal loop within 1 u8
        # (float64 summation order), as tests/test_core.py holds it
        sep = to.resize_oracle(img, scale).astype(np.int64)
        assert np.abs(sep - got.astype(np.int64)).max() <= 1
    assert got.dtype == want.dtype == np.uint8
    assert got.shape == want.shape
    assert got.tobytes() == want.tobytes()
