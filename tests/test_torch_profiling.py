"""The port's profiling and debugging utilities
(bicubic_interpolation_model_tpu_torch/utils/profiling.py): the three cases
of tests/test_profiling.py against the port, and the trace it writes."""

import json

import numpy as np
import pytest
import torch

from bicubic_interpolation_model_tpu_torch.utils import profiling


def test_device_memory_stats():
    stats = profiling.device_memory_stats()
    assert len(stats) >= 1
    assert "device" in stats[0]
    assert {"bytes_in_use", "peak_bytes_in_use", "bytes_limit"} <= set(
        stats[0])


def test_debug_mode_restores_flags():
    before = (torch.is_anomaly_enabled(),
              torch.is_anomaly_check_nan_enabled())
    with profiling.debug_mode(nans=True):
        assert torch.is_anomaly_enabled() is True
        assert torch.is_anomaly_check_nan_enabled() is True
        x = torch.tensor([-1.0], requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"), \
                pytest.warns(UserWarning, match="SqrtBackward"):
            torch.sqrt(x).sum().backward()
    assert (torch.is_anomaly_enabled(),
            torch.is_anomaly_check_nan_enabled()) == before


def test_checked_raises_on_nan():
    def bad(x):
        return torch.log(x)  # NaN for negative input
    f = profiling.checked(bad)
    assert np.isfinite(float(f(torch.tensor(1.0))))
    with pytest.raises(FloatingPointError):
        f(torch.tensor(-1.0))
    with pytest.raises(FloatingPointError):
        profiling.checked(lambda: {"a": (torch.ones(2),
                                         torch.tensor([np.inf]))})()


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(tmp_path / "t"):
        torch.ones(64, 64) @ torch.ones(64, 64)
    trace = json.loads((tmp_path / "t" / "trace.json").read_text())
    assert any("mm" in e.get("name", "") for e in trace["traceEvents"])
