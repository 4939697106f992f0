"""binning_ms: runner.timings["binning"] (CUDA events on the runner's
stream), the mean over the window's shells: tile binning (host numpy)
and its uploads."""


def read(ctx):
    return ctx.timing_ms("binning")
