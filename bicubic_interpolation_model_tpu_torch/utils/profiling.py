"""Tracing, memory and debugging utilities (counterpart of
``bicubic_interpolation_model_tpu/utils/profiling.py``):

- :func:`trace`: ``torch.profiler`` over a scope, written as a Chrome
  trace (view in Perfetto or ``chrome://tracing``);
- :func:`device_memory_stats`: memory per visible card;
- :func:`debug_mode`: autograd anomaly detection with its NaN check for a
  scope;
- :func:`checked`: a function that raises on non-finite outputs.
"""

from __future__ import annotations

import contextlib
import pathlib

import torch

_DEFAULT_TRACE_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" \
    / "trace"


@contextlib.contextmanager
def trace(log_dir=_DEFAULT_TRACE_DIR):
    """Profile the scope (host ops, and the card's kernels when one is
    visible) and write ``trace.json`` into ``log_dir`` (made if missing) on
    exit; yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    d = pathlib.Path(log_dir)
    d.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(d / "trace.json"))


def device_memory_stats() -> list[dict]:
    """Per visible card: bytes held by PyTorch's allocator now and at its
    peak (``torch.cuda.memory_stats``), and the card's total memory
    (``torch.cuda.mem_get_info``). Without a card, one CPU entry whose
    values are None, as the JAX function reports a host device."""
    if not torch.cuda.is_available():
        return [{"device": "cpu", "bytes_in_use": None,
                 "peak_bytes_in_use": None, "bytes_limit": None}]
    out = []
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out.append({
            "device": f"cuda:{i} {torch.cuda.get_device_name(i)}",
            "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
            "bytes_limit": torch.cuda.mem_get_info(i)[1],
        })
    return out


@contextlib.contextmanager
def debug_mode(nans: bool = True):
    """Autograd anomaly detection for the scope: a backward that fails
    names the forward op that made its input, and with ``nans`` a backward
    op that returns NaN raises. Both flags are restored on exit. PyTorch
    has no Inf counterpart of ``jax_debug_infs``; :func:`checked` covers
    Inf in a function's outputs."""
    old = (torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled())
    torch.autograd.set_detect_anomaly(True, check_nan=nans)
    try:
        yield
    finally:
        torch.autograd.set_detect_anomaly(*old)


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensors(v)


def checked(fn):
    """``fn`` wrapped to raise FloatingPointError when a floating tensor in
    its outputs (nested in tuples, lists or dicts) holds NaN or Inf. This
    is weaker than the JAX function's ``checkify``, which also checks
    index bounds and NaN inside kernels as they run: here only what comes
    out is checked, once the function has returned."""

    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        for t in _tensors(out):
            if t.is_floating_point() and not bool(torch.isfinite(t).all()):
                raise FloatingPointError(
                    f"{getattr(fn, '__name__', fn)} returned a non-finite "
                    f"tensor of shape {tuple(t.shape)}")
        return out

    return wrapper
