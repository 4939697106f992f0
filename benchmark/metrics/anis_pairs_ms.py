"""anis_pairs_ms: the self times of both pair searches of a call, the
canvas's (runner.timings["canvas.binning.bin"], ".refine", ".csr") and
the halo sum's ("binning.bin", ".refine", ".csr"), the mean over the
window's calls: the host's (tile, halo) pair search, its pruning and its
grouping per tile with the upload, twice."""

from benchmark import counts_anis

KEYS = ("binning.bin", "binning.refine", "binning.csr")


def read(ctx):
    if not counts_anis.traced(ctx):
        return None
    return ctx.timing_ms(*KEYS, *("canvas." + k for k in KEYS))
