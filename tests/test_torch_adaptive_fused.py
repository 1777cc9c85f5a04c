"""The kernel's route of the port's adaptive bicubic
(bicubic_interpolation_model_tpu_torch/ops/adaptive_fused.py: on the CPU its
plain version) against the JAX Pallas kernel in interpret mode, on the
all-class frames of tests/test_torch_adaptive.py.

Tolerances: uint8 outputs ≤1 LSB from the JAX kernel (f32 sums in another
order; the JAX kernel's texture law is a polynomial exp2 within 1.1e-4).
The JAX kernel reads the class of a centre beyond the last row or column
from a variance window around the unclamped position, while the oracle, the
jnp graph and the port read it at the clamped centre: on frames that leave
the edge class the two are compared on all LR cells but the last row and
column, and there the port is held to the oracle.
tests/test_torch_adaptive_layouts.py compares the layouts."""

import numpy as np
import pytest
import torch

from bicubic_interpolation_model_tpu.core.oracle import (
    adaptive_bicubic_oracle)
from bicubic_interpolation_model_tpu.ops import pallas_adaptive as jfused
from bicubic_interpolation_model_tpu_torch.ops import (
    adaptive_fused as tfused)

from test_torch_adaptive import (FRAMES, _max_diff, all_class_frame,
                                 class_counts)


@pytest.mark.parametrize("name", FRAMES)
@pytest.mark.parametrize("h,w,c,s,wstep", [
    (13, 11, 4, 4, 16), (8, 40, 3, 3, 16), (16, 12, 4, 2, 16),
    (9, 9, 3, 1, 16)])
def test_fused_route_matches_the_pallas_kernel(h, w, c, s, wstep, name):
    img = all_class_frame(name, h, w, c, seed=h + s)
    fused = tfused.adaptive_resize_fused(img, s, device="cpu").numpy()
    jkernel = np.asarray(jfused.adaptive_resize_pallas(
        img, s, step=8, wstep=wstep, interpret=True))
    inner = (slice(0, (h - 1) * s), slice(0, (w - 1) * s))
    region = (slice(None), slice(None)) if name == "noise" else inner
    assert _max_diff(fused[region], jkernel[region]) <= 1
    assert _max_diff(fused, adaptive_bicubic_oracle(img, float(s))) <= 1


def test_opaque_alpha_bit_equal_on_constant_alpha():
    img = all_class_frame("mosaic", 12, 16, 4, seed=5)
    img[..., 3] = 255
    fast = tfused.adaptive_resize_fused(img, 2, opaque_alpha=True,
                                        device="cpu")
    full = tfused.adaptive_resize_fused(img, 2, device="cpu")
    assert torch.equal(fast, full)
    rgb = tfused.adaptive_resize_fused(img[..., :3], 2, opaque_alpha=True,
                                       device="cpu")
    assert torch.equal(rgb, full[..., :3])       # C = 3 ignores the promise


def test_classes_out_reports_the_classes():
    img = all_class_frame("mosaic", 12, 14, 4, seed=13)
    cls = torch.empty((1, 12, 14), dtype=torch.uint8)
    tfused.adaptive_resize_fused(img, 2, device="cpu", classes_out=cls)
    counts = class_counts(img)
    assert {k: int((cls == k).sum()) for k in counts} == counts
    with pytest.raises(ValueError, match="classes_out"):
        tfused.adaptive_resize_fused(img, 2, device="cpu",
                                     classes_out=cls[:, :5])
