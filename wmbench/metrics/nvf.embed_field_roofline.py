"""The embed field kernel's bound (``work/kernels.py``, PERF.md §6's bound
column) at the cell's mask and p over its mean device time a launch in the
traced window, in %: every instantiation of ``embed_field_kernel``."""

from wmbench.trace import kernels
from wmbench.work.kernels import kernel_bound


def read(ctx):
    if ctx.summary is None:
        return None
    launches, seconds = kernels(ctx.summary, "embed_field_kernel")
    if not launches:
        return None
    config = ctx.config
    bound_ms, _ = kernel_bound("embed_field", config["mask"], config["p"],
                               ctx.params["batch"], config["rows"],
                               config["cols"])
    return 100.0 * bound_ms / 1e3 / (seconds / launches)
