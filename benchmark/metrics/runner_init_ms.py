"""runner_init_ms: host clock around a runner's constructor, the mean over
the window's shells (runner set-up)."""

import numpy as np


def read(ctx):
    vals = [u["init_ms"] for u in ctx.done()]
    return float(np.mean(vals)) if vals else None
