"""Host ms a batch that ``video.detect_video`` waited for its results to
land in the pinned outputs (its ``stats``: ``collect_s`` over
``batches``, summed over the window's passes; program counters)."""


def read(ctx):
    batches = ctx.counters.get("video.batches")
    if not batches:
        return None
    return 1e3 * ctx.counters["video.collect_s"] / batches
