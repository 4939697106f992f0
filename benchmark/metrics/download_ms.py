"""download_ms: runner.timings["download"] (CUDA events on the runner's
stream), the mean over the window's shells: the map's download
(process()'s .cpu())."""


def read(ctx):
    return ctx.timing_ms("download")
