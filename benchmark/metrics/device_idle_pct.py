"""device_idle_pct: 100 (1 - busy / window), busy the union of the traced
window's device operations (kernels, copies, sets) by torch.profiler."""


def read(ctx):
    if ctx.trace is None or ctx.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace["busy_s"] / ctx.trace["window_s"])
