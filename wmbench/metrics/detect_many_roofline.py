"""The multi-candidate detect kernel's bound (``work/kernels.py``,
PERF.md §6's bound column) over its mean device time a launch in the traced
window, in %."""

from wmbench.trace import kernels
from wmbench.work.kernels import kernel_bound


def read(ctx):
    if ctx.summary is None:
        return None
    launches, seconds = kernels(ctx.summary, "detect_many_kernel")
    if not launches:
        return None
    config, params = ctx.config, ctx.params
    bound_ms, _ = kernel_bound("detect_many", config["mask"], config["p"],
                               params["batch"], config["rows"],
                               config["cols"], params["candidates"])
    return 100.0 * bound_ms / 1e3 / (seconds / launches)
