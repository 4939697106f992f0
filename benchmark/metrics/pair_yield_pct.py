"""pair_yield_pct: 100 runner.timings["count.pairs_kept"] /
["count.pairs"], the mean over the window's calls: the share of the
binned (tile, halo) pairs that the pruning keeps."""

import numpy as np


def read(ctx):
    vals = [100.0 * u["timings"]["count.pairs_kept"]
            / u["timings"]["count.pairs"]
            for u in ctx.done()
            if u["timings"].get("count.pairs", 0) > 0
            and "count.pairs_kept" in u["timings"]]
    return float(np.mean(vals)) if vals else None
