"""roofline_pct.anis_finish: the least time of the finish
(``counts_anis.anis_finish``: the halo sum and the canvas read, the map
read and the painted map written once, summed over the window's shells)
over the device time of K14 (``anis_finish_kernel``) in the traced
window."""

from benchmark import counts_anis


def read(ctx):
    t = ctx.device_seconds(("anis_finish_kernel",))
    if t is None or not counts_anis.traced(ctx):
        return None
    return 100.0 * counts_anis.least_seconds(ctx, counts_anis.anis_finish) / t
