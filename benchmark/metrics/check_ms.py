"""check_ms: runner.timings["process.check"] (the program's span on the
host clock), the mean over the window's calls: the mass-conservation
check after the download, two sums of the maps on the host."""


def read(ctx):
    return ctx.timing_ms("process.check")
