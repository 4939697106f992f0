"""anis_finish_ms: runner.timings["finish"] (CUDA events), the mean over
the window's calls: K14, the halo sum weighted by the map over the
canvas plus the background's tracer term."""

from benchmark import counts_anis


def read(ctx):
    return ctx.timing_ms("finish") if counts_anis.traced(ctx) else None
