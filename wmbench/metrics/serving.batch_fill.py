"""Real frames a dispatched batch holds, as a share of the batch size, over
the window's batches (``DetectorService.stats()``: ``mean_batch_fill`` and
``batches``, differenced across the window). Low fill means the flush
timeout dispatches part-empty batches of padding."""


def read(ctx):
    batches = ctx.counters.get("batches")
    if not batches:
        return None
    return (100.0 * ctx.counters["batched_frames"]
            / (batches * ctx.counters["batch_size"]))
