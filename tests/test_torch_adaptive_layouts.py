"""The layouts of the port's fused adaptive route
(bicubic_interpolation_model_tpu_torch/ops/adaptive_fused.py: ``hwc``,
``hwc32``, ``planar`` and ``unpack_planar``; on the CPU the plain version)
against the forms of the JAX Pallas kernel in interpret mode.

Tolerances: within each package the forms are byte-equal (the port's
``unpack_planar`` decodes the JAX planar form too, slicing off the extents
the JAX kernel pads to its tile grid); across packages the bytes on the valid
extents hold ≤1 u8 LSB, as the outputs themselves do."""

import numpy as np
import pytest
import torch

from bicubic_interpolation_model_tpu.ops import pallas_adaptive as jfused
from bicubic_interpolation_model_tpu_torch.ops import (
    adaptive_fused as tfused)

from test_torch_adaptive import _max_diff, all_class_frame


def test_layouts_are_byte_equal_forms():
    h, w, c, s = 16, 32, 4, 2
    img = all_class_frame("noise", h, w, c, seed=9)
    jax_form = lambda **kw: np.asarray(jfused.adaptive_resize_pallas(
        img, s, step=8, wstep=128, interpret=True, **kw))
    hwc = tfused.adaptive_resize_fused(img, s, device="cpu")
    planar = tfused.adaptive_resize_fused(img, s, layout="planar",
                                          device="cpu")
    assert planar.dtype == torch.uint32 and planar.shape == (s, h * s, w)
    assert torch.equal(tfused.unpack_planar(planar, h, w, s, c), hwc)
    jplanar, jhwc = jax_form(layout="planar"), jax_form()
    # the JAX form pads its extents to the tile grid: the port's decoder
    # slices them off
    np.testing.assert_array_equal(
        tfused.unpack_planar(torch.from_numpy(jplanar.copy()), h, w, s,
                             c).numpy(), jhwc)
    valid = np.ascontiguousarray(jplanar[:, :h * s, :w]).view(np.uint8)
    assert _max_diff(planar.numpy().view(np.uint8), valid) <= 1

    words = tfused.adaptive_resize_fused(img, s, layout="hwc32",
                                         device="cpu")
    assert words.dtype == torch.uint32 and words.shape == (h * s, w * s)
    np.testing.assert_array_equal(
        words.numpy().view(np.uint8).reshape(h * s, w * s, 4), hwc.numpy())
    jwords = jax_form(layout="hwc32")
    assert jwords.shape == words.shape and jwords.dtype == np.uint32
    assert _max_diff(words.numpy().view(np.uint8),
                     np.ascontiguousarray(jwords).view(np.uint8)) <= 1

    batch = tfused.adaptive_resize_fused(np.stack([img, img]), s,
                                         layout="planar", device="cpu")
    assert batch.shape == (2, s, h * s, w)
    assert torch.equal(tfused.unpack_planar(batch, h, w, s, c)[1], hwc)
    words_b = tfused.adaptive_resize_fused(np.stack([img, img]), s,
                                           layout="hwc32", device="cpu")
    assert words_b.shape == (2, h * s, w * s) and torch.equal(
        words_b[0].view(torch.uint8), words.view(torch.uint8))


@pytest.mark.parametrize("h,w,c,s", [(11, 9, 3, 3), (8, 8, 4, 4),
                                     (5, 7, 3, 1)])
def test_planar_decodes_to_hwc(h, w, c, s):
    img = all_class_frame("mosaic", h, w, c, seed=h)
    hwc = tfused.adaptive_resize_fused(img, s, device="cpu")
    planar = tfused.adaptive_resize_fused(img, s, layout="planar",
                                          device="cpu")
    assert planar.dtype == torch.uint32 and planar.shape == (s, h * s, w)
    assert torch.equal(tfused.unpack_planar(planar, h, w, s, c), hwc)
    if c == 3:
        assert int(planar.numpy().max()) < 2 ** 24    # top byte unused
        with pytest.raises(ValueError, match="4 channels"):
            tfused.adaptive_resize_fused(img, s, layout="hwc32",
                                         device="cpu")
