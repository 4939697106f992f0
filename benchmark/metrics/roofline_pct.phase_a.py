"""roofline_pct.phase_a: the least time of phase A's work
(``counts.phase_a``, summed over the window's shells) over the summed
device time of its kernels in the traced window: K1 (curve collapse), K4
(the tile deposit, ``tile_pairs_kernel``) and K2 (the disc deposit of the
small discs)."""

KERNELS = ("collapse_curves_kernel", "collapse_curves_wide",
           "tile_pairs_kernel", "disc_deposit_kernel")


def read(ctx):
    t = ctx.device_seconds(KERNELS)
    return None if t is None else 100.0 * ctx.least_seconds("phase_a") / t
