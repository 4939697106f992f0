"""The least work of the anisotropic paint's layers (configuration
``anis_paint``), for its roofline metrics, counted from the cell's inputs
as ``counts.py`` counts the other layers' (the same peaks, bytes read and
written once, the discs' member pixels of ``counts.member_pixels``).

* the paint: the Mtot canvas (``counts.paint``: the halos' columns and
  its table read once, the f32 canvas written once, 14 operations a
  member pixel), then the halo sum of the model's and the tracer's curves
  (the halos' columns and both float64 tables read once, the sum written
  once in the paint dtype, ``PAINT2_OPS`` a member pixel);
* the finish: per pixel the halo sum and the canvas read in the paint
  dtype, the input map read and the painted map written in float64,
  ``FINISH_OPS`` float64 operations.
"""

from . import counts

__all__ = ["PAINT2_OPS", "FINISH_OPS", "paint2", "anis_paint",
           "anis_finish", "least_seconds", "traced"]

# operations per member pixel of the halo sum, the least any
# implementation does: the chord (5), the radius (1), the lerps of the two
# log curves (10), their sum and its exp (2), the 1/a^2 factor (1) and the
# accumulation (1): 20
PAINT2_OPS = 20
# per pixel of the finish: the canvas plus the background (1), the halo
# sum times the map over it (2), the background's share of it times the
# map (2), times the tracer weight (1) and the sum (1): 7
FINISH_OPS = 7


def paint2(cfg, shell, members):
    """(bytes, ops, dtype) of the halo sum."""
    dt = cfg["runner"]["dtype"]
    npix = 12 * cfg["nside"] ** 2
    b = shell["M"].size * counts.HALO_BYTES \
        + 2 * counts._table_values(cfg) * counts._SIZE["float64"] \
        + npix * counts._SIZE[dt]
    return b, members * PAINT2_OPS, dt


def anis_paint(cfg, shell, members):
    """(bytes, ops, dtype) of the canvas and the halo sum together."""
    b1, o1, dt = counts.paint(cfg, shell, members)
    b2, o2, _ = paint2(cfg, shell, members)
    return b1 + b2, o1 + o2, dt


def anis_finish(cfg, shell, members):
    """(bytes, ops, dtype) of the finish."""
    npix = 12 * cfg["nside"] ** 2
    b = npix * (2 * counts._SIZE[cfg["runner"]["dtype"]]
                + 2 * counts._SIZE["float64"])
    return b, npix * FINISH_OPS, "float64"


def least_seconds(ctx, layer):
    """The layer's least time (``layer`` one of this module's counts)
    summed over the shells of the window's units."""
    return sum(counts.least_seconds(*layer(ctx.cfg, ctx.shells[i],
                                           ctx.members(i)))
               for i in (u["shell"] for u in ctx.done()))


def traced(ctx):
    """Whether the window's calls traced the anisotropic paint (its
    ``anis.background`` span): the anis_* readers read nothing from a
    program without that tracing."""
    return any("anis.background" in u["timings"] for u in ctx.done())
