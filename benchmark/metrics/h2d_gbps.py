"""h2d_gbps: runner.timings["count.h2d_bytes"] over the self time of its
copies (the span "copy.h2d"), the mean over the window's calls that
copied: the bytes the call put on the card over the host's time in those
copies (an asynchronous copy's time is its enqueue), in GB/s."""

import numpy as np


def read(ctx):
    vals = [u["timings"]["count.h2d_bytes"] / (1e6 * u["timings"]["copy.h2d"])
            for u in ctx.done()
            if u["timings"].get("copy.h2d", 0) > 0
            and "count.h2d_bytes" in u["timings"]]
    return float(np.mean(vals)) if vals else None
