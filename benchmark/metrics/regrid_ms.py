"""regrid_ms: runner.timings["regrid"] (CUDA events on the runner's
stream), the mean over the window's shells: shell phase B (K5, K7, K6;
K3 on the scatter path)."""


def read(ctx):
    return ctx.timing_ms("regrid")
