"""roofline_pct.anis_paint: the least time of the canvas paint and the
halo sum (``counts_anis.anis_paint``, summed over the window's shells)
over the summed device time of their kernels in the traced window: K1
(curve collapse, three models), K10 and K12 (``tile_pairs_kernel``), K7
(the layouts to RING order), K11 and K13 (the disc paints)."""

from benchmark import counts_anis

KERNELS = ("collapse_curves_kernel", "tile_pairs_kernel", "layout_kernel",
           "disc_paint_kernel", "disc_paint_anis_kernel")


def read(ctx):
    t = ctx.device_seconds(KERNELS)
    if t is None or not counts_anis.traced(ctx):
        return None
    return 100.0 * counts_anis.least_seconds(ctx, counts_anis.anis_paint) / t
