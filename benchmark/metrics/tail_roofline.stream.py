"""The learned tail's least time from its work (the frozen
:func:`benchmark.work.tail_bound` count) over the device ms per frame of
every kernel that is not a copy and not one of the dense convs (profiler
trace): kernels A and B and the inference graph's own small kernels."""

from benchmark import work


def read(ctx):
    if ctx.trace is None or not ctx.frames:
        return None
    h, w, c = ctx.mix["frame"]
    ms = ctx.trace.kernel_s(exclude=("convs",)) * 1e3 / ctx.frames
    return 100.0 * work.tail_bound(h, w, c)[0] / ms if ms > 0 else None
