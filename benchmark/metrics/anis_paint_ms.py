"""anis_paint_ms: runner.timings["curves"] + ["paint"] (CUDA events), the
mean over the window's calls: the model's and the tracer's curves (K1;
the phase also holds the host's background, ``anis.background``, with
its wait for the canvas) and the halo sum (K12, K7)."""

from benchmark import counts_anis


def read(ctx):
    if not counts_anis.traced(ctx):
        return None
    return ctx.timing_ms("curves", "paint")
