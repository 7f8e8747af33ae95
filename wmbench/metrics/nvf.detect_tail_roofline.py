"""The detect tail's bound (``work/kernels.py``, PERF.md §6's bound
column) at the cell's mask and p over the mean device time a launch of
``detect_tail_kernel`` in the traced window, in %: the one-block-a-tile
kernel that NVF takes; the name leaves out ME p=3's
``detect_tail_pipelined_kernel``."""

from wmbench.trace import kernels
from wmbench.work.kernels import kernel_bound


def read(ctx):
    if ctx.summary is None:
        return None
    launches, seconds = kernels(ctx.summary, "detect_tail_kernel")
    if not launches:
        return None
    config = ctx.config
    bound_ms, _ = kernel_bound("detect_tail", config["mask"], config["p"],
                               ctx.params["batch"], config["rows"],
                               config["cols"])
    return 100.0 * bound_ms / 1e3 / (seconds / launches)
