"""Antialiased image downsampling (counterpart of
``bicubic_interpolation_model_tpu/ops/downsample.py``).

Two dense sampling-matrix products in f32 from :func:`..core.plan.
plan_downsample` (HR→LR generation: ``cubic`` or ``lanczos3``). The JAX
package computes them outside any kernel at full f32 precision, so they are
two ``torch.matmul`` s here, with TF32 kept off. The JAX package builds the
two matrices once per shape, as constants of its jitted program; here they
are built and uploaded once per shape and device (:func:`_matrices`).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..core import plan as planlib
from ..runtime.device import full_f32_matmul, resolve_device
from .resize import round_u8


def _out_shape(h, w, factor, out_shape):
    if out_shape is None:
        return int(h // factor), int(w // factor)
    return out_shape


@functools.lru_cache(maxsize=16)
def _matrices(h: int, w: int, factor: float, method: str, h_out: int,
              w_out: int, device: torch.device):
    """The row matrix [h_out, h] and the transposed column matrix
    [w, w_out], f32 on ``device``, built once per key."""
    dev = lambda arr: torch.from_numpy(np.ascontiguousarray(arr)).to(device)
    m_row = dev(planlib.plan_to_matrix(
        planlib.plan_downsample(h, factor, method, n_out=h_out)))
    m_col_t = dev(planlib.plan_to_matrix(
        planlib.plan_downsample(w, factor, method, n_out=w_out)).T)
    return m_row, m_col_t


def downsample(img, factor: float, method: str = "cubic",
               out_shape: tuple[int, int] | None = None, *, device="cuda"):
    """Downsample an HW/HWC image (numpy or tensor) by ``factor`` (>= 1) with
    antialiasing; returns a tensor on ``device`` (the card by default:
    without one it raises unless given ``device="cpu"``).

    uint8 → uint8 (round half-up), float → float."""
    img = torch.as_tensor(img).to(resolve_device(device))
    squeeze = img.dim() == 2
    if squeeze:
        img = img[..., None]
    h, w = img.shape[:2]
    h_out, w_out = _out_shape(h, w, factor, out_shape)
    m_row, m_col_t = _matrices(int(h), int(w), float(factor), method,
                               int(h_out), int(w_out), img.device)
    in_dtype = img.dtype
    chw = img.permute(2, 0, 1).to(torch.float32)
    with full_f32_matmul():
        out = torch.matmul(torch.matmul(m_row, chw), m_col_t)
    out = out.permute(1, 2, 0)
    if squeeze:
        out = out[..., 0]
    if in_dtype == torch.uint8:
        return round_u8(out)
    return out.to(in_dtype)


def downsample_np(img: np.ndarray, factor: float, method: str = "cubic",
                  out_shape: tuple[int, int] | None = None) -> np.ndarray:
    """Host-side NumPy variant (float64): the same plans and semantics as
    :func:`downsample`, for data pipelines that stay off the device."""
    img = np.asarray(img)
    squeeze = img.ndim == 2
    if squeeze:
        img = img[..., None]
    h, w = img.shape[:2]
    h_out, w_out = _out_shape(h, w, factor, out_shape)
    m_row = planlib.plan_to_matrix(
        planlib.plan_downsample(h, factor, method, n_out=h_out), np.float64)
    m_col = planlib.plan_to_matrix(
        planlib.plan_downsample(w, factor, method, n_out=w_out), np.float64)
    x = img.astype(np.float64)
    t = np.einsum("oh,hwc->owc", m_row, x)
    out = np.einsum("owc,xw->oxc", t, m_col)
    if img.dtype == np.uint8:
        out = np.clip(np.floor(out + 0.5), 0, 255).astype(np.uint8)
    else:
        out = out.astype(img.dtype)
    return out[..., 0] if squeeze else out
