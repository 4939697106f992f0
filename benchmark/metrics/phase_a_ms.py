"""phase_a_ms: runner.timings["curves"] + ["deposit"] (CUDA events), the
mean over the window's shells: curve collapse (K1) and shell phase A
(K4, K2)."""


def read(ctx):
    if ctx.timing_ms("deposit") is None:
        return None
    return ctx.timing_ms("curves", "deposit")
