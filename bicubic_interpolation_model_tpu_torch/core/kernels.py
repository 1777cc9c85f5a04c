"""Interpolation kernel functions (NumPy, float64).

These are the scalar kernel definitions used to build axis resampling plans.
Semantics match the reference implementations exactly:

- Keys cubic: reference version3.0/utils/bicubic_super_resolution.js:28-33
  (``cubicWeight`` with parameter ``a``, default -0.5 / Catmull-Rom).
- Lanczos:    reference version3.0/utils/lanczos_super_resolution.js:8-13
  (``lanczosKernel`` with window ``a``, default 3).

Everything here is NumPy/float64 and runs on host; device-side code consumes the
resulting weight tables (see :mod:`..ops`). The port's own copy of
``bicubic_interpolation_model_tpu/core/kernels.py`` (the port imports
nothing of the JAX package); ``tests/test_torch_core.py`` holds the two
equal bit for bit.
"""

from __future__ import annotations

import numpy as np


def cubic_keys(x: np.ndarray, a: float = -0.5) -> np.ndarray:
    """Keys piecewise-cubic kernel.

    w(x) = (a+2)|x|^3 - (a+3)|x|^2 + 1          for |x| <= 1
         = a|x|^3 - 5a|x|^2 + 8a|x| - 4a        for 1 < |x| <= 2
         = 0                                    otherwise

    Matches the JS ``cubicWeight`` including branch boundaries (|x|==1 takes the
    first branch, |x|==2 the second — both give the same value there).
    """
    x = np.abs(np.asarray(x, dtype=np.float64))
    r = np.zeros_like(x)
    m1 = x <= 1.0
    m2 = (x > 1.0) & (x <= 2.0)
    x1 = x[m1]
    x2 = x[m2]
    r[m1] = (a + 2.0) * x1**3 - (a + 3.0) * x1**2 + 1.0
    r[m2] = a * x2**3 - 5.0 * a * x2**2 + 8.0 * a * x2 - 4.0 * a
    return r


def lanczos(x: np.ndarray, a: int = 3) -> np.ndarray:
    """Lanczos windowed-sinc kernel.

    w(0) = 1; w(x) = 0 for |x| > a;
    else  a*sin(pi x)*sin(pi x / a) / (pi x)^2.
    """
    x = np.asarray(x, dtype=np.float64)
    r = np.zeros_like(x)
    inside = (np.abs(x) <= a) & (x != 0.0)
    xi = x[inside]
    px = np.pi * xi
    r[inside] = a * np.sin(px) * np.sin(px / a) / (px * px)
    r[x == 0.0] = 1.0
    return r


def bilinear_hat(x: np.ndarray) -> np.ndarray:
    """Triangle (hat) kernel: max(0, 1-|x|)."""
    x = np.abs(np.asarray(x, dtype=np.float64))
    return np.maximum(0.0, 1.0 - x)
