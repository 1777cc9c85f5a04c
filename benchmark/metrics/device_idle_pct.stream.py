"""Share of the traced window in which no kernel, copy or memset ran on
the device: 1 - (union of their intervals) / window (profiler trace)."""


def read(ctx):
    if ctx.trace is None:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)
