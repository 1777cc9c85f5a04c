"""The published ESRGAN generator's convs' least time from their work
(:func:`benchmark.work_esrgan.conv_bound`: bytes once, FLOPs at 3xTF32's
165 TFLOP/s) over the device ms per frame of the kernels that
``layers/convs.json`` assigns to the dense convs (profiler trace)."""

from benchmark import work_esrgan


def read(ctx):
    if ctx.trace is None or not ctx.frames:
        return None
    h, w, _ = ctx.mix["frame"]
    bound = work_esrgan.conv_bound(h, w, features=ctx.config["features"],
                                   growth=ctx.config["growth"],
                                   n_blocks=ctx.config["n_blocks"])[0]
    ms = ctx.trace.kernel_s("convs") * 1e3 / ctx.frames
    return 100.0 * bound / ms if ms > 0 else None
