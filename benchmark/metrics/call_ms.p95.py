"""call_ms.p95: the 95th percentile (linear interpolation between order
statistics) of the host-clock times of the window's calls, each from the
runner's construction to its output on the host."""

import numpy as np


def read(ctx):
    vals = [u["unit_ms"] for u in ctx.done()]
    return float(np.percentile(vals, 95)) if vals else None
