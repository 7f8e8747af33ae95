"""What the metric readers share; each metric's own file in ``metrics/``
names one of these, or reads something of its own.

A reader takes the run's ``harness.Context`` and returns a number, or None
where the run has nothing to read (a plain run has no trace)."""

from __future__ import annotations

from .trace import kernels
from .work.peaks import least_seconds


def window_rate(ctx):
    """Frames a second: every frame of the window's calls over the whole
    window, which ends after a synchronize (host clock)."""
    seconds, _ = ctx.spans["window"]
    return ctx.counters["frames"] / seconds


def enqueue_ms(ctx):
    """Host ms to enqueue one step: the host clock around
    ``enqueue_steps`` steps with no synchronize between them, the median
    of ``enqueue_rounds`` rounds, before the profiler starts. The card runs
    behind without pacing the host while its launch queue has room, so
    this is the launch path's cost alone."""
    if "enqueue" not in ctx.spans:
        return None
    seconds, steps = ctx.spans["enqueue"]
    return 1e3 * seconds / steps


def kernels_per_call(ctx):
    """Device kernels a call in the traced window (copies and fills are
    not kernels)."""
    if ctx.summary is None:
        return None
    launches, _ = kernels(ctx.summary)
    calls = ctx.spans["window"][1]
    return launches / calls if launches and calls else None


def op_roofline(ctx):
    """The cell's operation's least time on the card (its ``work/`` module's
    bytes and flops at ``work/peaks.py``'s peaks, whichever binds) over its
    device busy time a call in the traced window, in %. Counted for the
    operation, not for the kernels that do it today, so no fusion can carry
    it past 100%."""
    if ctx.summary is None or not ctx.summary["busy_s"]:
        return None
    least, _ = least_seconds(*ctx.work(), ctx.device_name)
    busy = ctx.summary["busy_s"] / ctx.spans["window"][1]
    return 100.0 * least / busy
