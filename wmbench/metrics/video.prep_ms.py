"""Host ms a batch that ``video.detect_video`` took to fill the pinned
staging buffer with the sampled lumas and enqueue the upload and the
detection (its ``stats``: ``prep_s`` over ``batches``, summed over the
window's passes; program counters)."""


def read(ctx):
    batches = ctx.counters.get("video.batches")
    if not batches:
        return None
    return 1e3 * ctx.counters["video.prep_s"] / batches
