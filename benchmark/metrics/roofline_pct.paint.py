"""roofline_pct.paint: the least time of the paint's work
(``counts.paint``, summed over the window's shells) over the summed device
time of its kernels in the traced window: K1 (curve collapse), K10 (the
tile paint, ``tile_pairs_kernel``), K7 (the layout to RING order) and K11
(the disc paint)."""

KERNELS = ("collapse_curves_kernel", "collapse_curves_wide",
           "tile_pairs_kernel", "layout_kernel", "disc_paint_kernel")


def read(ctx):
    t = ctx.device_seconds(KERNELS)
    return None if t is None else 100.0 * ctx.least_seconds("paint") / t
