"""anis_canvas_ms: runner.timings["canvas"] (CUDA events), the mean over
the window's calls: the Mtot canvas, from the end of host prep to its
last launch (its curves K1, its pair search on the host, K10 and K7)."""

from benchmark import counts_anis


def read(ctx):
    return ctx.timing_ms("canvas") if counts_anis.traced(ctx) else None
