"""The 95th percentile of the latency of every request due in the window,
from when it was due to when its answer came (host clock); a refused or
unanswered request counts with the time until the run stopped waiting."""

import numpy as np


def read(ctx):
    if ctx.latencies_s is None or len(ctx.latencies_s) == 0:
        return None
    return float(np.percentile(ctx.latencies_s, 95) * 1e3)
