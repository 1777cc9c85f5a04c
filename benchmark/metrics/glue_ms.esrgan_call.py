"""Device ms per frame of every kernel outside the dense convs, copies
excluded (profiler trace): the published ESRGAN generator's
concatenations, leaky ReLUs, scaled residual adds, nearest upsamples and
the output's rounding."""


def read(ctx):
    if ctx.trace is None or not ctx.frames:
        return None
    return ctx.trace.kernel_s(exclude=("convs",)) * 1e3 / ctx.frames
