"""Mean ms from a batch's dispatch to its results on the host, over the
window's batches (``stats()``: ``mean_batch_latency_s`` and ``batches``,
differenced across the window): the device's work, the wait behind the
batch in flight before it and the copy back."""


def read(ctx):
    batches = ctx.counters.get("batches")
    if not batches:
        return None
    return 1e3 * ctx.counters["batch_latency_s"] / batches
