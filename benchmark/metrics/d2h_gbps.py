"""d2h_gbps: runner.timings["count.d2h_bytes"] over the self time of its
copies (the span "copy.d2h", timed after a sync of the card's stream),
the mean over the window's calls that copied: the output map's download,
in GB/s."""

import numpy as np


def read(ctx):
    vals = [u["timings"]["count.d2h_bytes"] / (1e6 * u["timings"]["copy.d2h"])
            for u in ctx.done()
            if u["timings"].get("copy.d2h", 0) > 0
            and "count.d2h_bytes" in u["timings"]]
    return float(np.mean(vals)) if vals else None
