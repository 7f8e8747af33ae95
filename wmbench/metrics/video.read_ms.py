"""Host ms a frame that ``video.detect_video`` waited on the frame pump
(its ``stats``: ``read_s`` over ``frames``, summed over the window's
passes; program counters)."""


def read(ctx):
    frames = ctx.counters.get("video.frames")
    if not frames:
        return None
    return 1e3 * ctx.counters["video.read_s"] / frames
