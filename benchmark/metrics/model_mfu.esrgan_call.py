"""The published ESRGAN generator's FLOPs (from its layer shapes,
:func:`benchmark.work_esrgan.flops`) times the frames served in the traced
window, over the window's seconds times 165 TFLOP/s, the rate of
f32-accurate products on the tensor cores (3xTF32)."""

from benchmark import work, work_esrgan


def read(ctx):
    if not ctx.frames:
        return None
    h, w, _ = ctx.mix["frame"]
    flops = work_esrgan.flops(h, w, features=ctx.config["features"],
                              growth=ctx.config["growth"],
                              n_blocks=ctx.config["n_blocks"])
    return 100.0 * flops * ctx.frames / (
        ctx.window.seconds * work.F32_MMA_FLOP_PER_S)
