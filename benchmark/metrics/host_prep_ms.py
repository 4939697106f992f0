"""host_prep_ms: runner.timings["host_prep"] (CUDA events on the runner's
stream), the mean over the window's shells: host prep (halo data,
uploads)."""


def read(ctx):
    return ctx.timing_ms("host_prep")
