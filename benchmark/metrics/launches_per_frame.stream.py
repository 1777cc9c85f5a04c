"""Host calls that launch a kernel in the traced window, cuDNN's
included, per frame served (profiler trace; the hand kernels' launches
agree with their wrappers' counters, or the trace is taken again)."""


def read(ctx):
    if ctx.trace is None or not ctx.frames:
        return None
    return len(ctx.trace.launches) / ctx.frames
