"""pairs_per_halo: runner.timings["count.pairs_kept"] (the (tile, halo)
pairs the pruning keeps) over the call's halos, the mean over the
window's calls: the tile deposit's or paint's work a halo."""

import numpy as np


def read(ctx):
    vals = [u["timings"]["count.pairs_kept"] / u["halos"]
            for u in ctx.done()
            if "count.pairs_kept" in u["timings"] and u.get("halos")]
    return float(np.mean(vals)) if vals else None
