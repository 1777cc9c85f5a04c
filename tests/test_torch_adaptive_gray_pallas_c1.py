"""Kernel E's route of the port's adaptive bicubic on 1-channel (gray)
uint8 frames (its plain version on the CPU, in
bicubic_interpolation_model_tpu_torch/ops/adaptive_fused.py) against the JAX
Pallas kernel in interpret mode, on the all-class frames. The check and its
tolerances are tests/test_torch_adaptive_gray.check_against_pallas: ≤1 u8
LSB from the JAX kernel, leaving out the last LR row and column where a
frame leaves the edge class (the JAX kernel's known deviation there). One
file per channel count, so that the slow interpret-mode compiles spread over
the test workers."""

import pytest

from test_torch_adaptive_gray import SCALES, SIZES, check_against_pallas


@pytest.mark.parametrize("s", SCALES)
@pytest.mark.parametrize("h,w", SIZES)
def test_c1_matches_the_pallas_kernel(h, w, s):
    check_against_pallas(h, w, 1, s)
