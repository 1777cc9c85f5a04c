"""Device ms per frame of the kernels that ``layers/convs.json`` assigns
to the dense convs (profiler trace)."""


def read(ctx):
    if ctx.trace is None or not ctx.frames:
        return None
    return ctx.trace.kernel_s("convs") * 1e3 / ctx.frames
