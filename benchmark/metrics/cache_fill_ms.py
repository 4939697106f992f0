"""cache_fill_ms: the sum of runner.timings["cache.*"] (the program's spans
around each fill of a geometry cache: the tiling, its circumradii, its
device tables, the stencil's tables and source list; self times), the
mean over the window's calls that looked a cache up (a call that found
every entry reads 0): what a new runner pays to rebuild its per-NSIDE
geometry."""

import numpy as np


def read(ctx):
    vals = [sum(v for k, v in u["timings"].items() if k.startswith("cache."))
            for u in ctx.done()
            if any(k.startswith(("cache.", "count.cache_"))
                   for k in u["timings"])]
    return float(np.mean(vals)) if vals else None
