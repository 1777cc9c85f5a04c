"""The learned model step's FLOPs (from the checkpoint's layer shapes,
:func:`benchmark.work.weight_predictor_flops`) times the frames served in
the traced window, over the window's seconds times 165 TFLOP/s, the
rate of f32-accurate products on the tensor cores (3xTF32)."""

from benchmark import work


def read(ctx):
    if not ctx.frames:
        return None
    h, w, c = ctx.mix["frame"]
    flops = work.weight_predictor_flops(h, w, c, ctx.config["features"],
                                        ctx.config["scale"])
    return 100.0 * flops * ctx.frames / (
        ctx.window.seconds * work.F32_MMA_FLOP_PER_S)
