"""The resize's least time from its work (input read once, output written
once: :func:`benchmark.work.resize_bound`) over the device ms per frame of
every kernel that is not a copy (profiler trace)."""

from benchmark import work


def read(ctx):
    if ctx.trace is None or not ctx.frames:
        return None
    h, w, c = ctx.mix["frame"]
    s = ctx.config["scale"]
    bound = work.resize_bound(1, h, w, c, round(h * s), round(w * s), 4)[0]
    ms = ctx.trace.kernel_s() * 1e3 / ctx.frames
    return 100.0 * bound / ms if ms > 0 else None
