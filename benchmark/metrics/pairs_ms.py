"""pairs_ms: runner.timings["binning.bin"] + ["binning.refine"] +
["binning.csr"] (the program's spans, self times: a cache fill inside
them is cache_fill_ms's), the mean over the window's calls: the host's
(tile, halo) pair search, its pruning and its grouping per tile with
the upload."""


def read(ctx):
    return ctx.timing_ms("binning.bin", "binning.refine", "binning.csr")
