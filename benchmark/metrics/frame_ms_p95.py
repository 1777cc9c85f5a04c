"""95th percentile over all calls of the window of ``__call__`` until
its host array is returned (host clock)."""

from benchmark.harness import percentile


def read(ctx):
    return percentile(ctx.window.times, 0.95) * 1e3
