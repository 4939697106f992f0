"""paint_ms: runner.timings["curves"] + ["paint"] (CUDA events), the mean
over the window's shells: curve collapse (K1) and the paint (K10, K7)."""


def read(ctx):
    if ctx.timing_ms("paint") is None:
        return None
    return ctx.timing_ms("curves", "paint")
