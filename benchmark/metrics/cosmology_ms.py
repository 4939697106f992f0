"""cosmology_ms: runner.timings["host_prep.cosmology"] (the program's span
on the host clock, self time), the mean over the window's calls: the
per-halo cosmology of host prep (R_Delta, D_A) and the runner's
cosmology."""


def read(ctx):
    return ctx.timing_ms("host_prep.cosmology")
