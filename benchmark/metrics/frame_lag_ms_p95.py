"""95th percentile over all frames of the window of the time from a
frame's handover to ``stream()`` to its host array's yield (host clock)."""

from benchmark.harness import percentile


def read(ctx):
    return percentile(ctx.window.times, 0.95) * 1e3
