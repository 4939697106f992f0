"""roofline_pct.phase_b: the least time of phase B's work
(``counts.phase_b``, summed over the window's shells) over the summed
device time of its kernels in the traced window: K5 (the hot-tile test
and the stencil), K7 (the tile layouts; its small-disc use in phase A is
counted here too), K6 (the complement and its source list) and K3 (the
scatter regrid)."""

KERNELS = ("stencil_hot_kernel", "stencil_kernel", "stencil_geo_kernel",
           "stencil_complement_kernel", "layout_kernel",
           "regrid_init_kernel", "regrid_move_kernel")


def read(ctx):
    t = ctx.device_seconds(KERNELS)
    return None if t is None else 100.0 * ctx.least_seconds("phase_b") / t
