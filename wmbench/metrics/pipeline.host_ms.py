"""Host ms a bulk step in the pipeline layer's own code: the outermost
``pipeline.*`` spans (``ops/pipelines.py``) less their ``kernels.*``
children, over the traced window's steps (program spans); read by
``pipeline.host_ms.<tag>``.

Read with the profiler on, so the value includes the profiler's cost of
recording the pipeline's aten ops (about 0.175 against 0.091 ms a 1080p
step on the H100 under ``utils.profiling.recording()`` alone; PERF.md §6).
A change that removes aten ops from the pipeline gains here partly by
that cost: it should cite a ``recording()`` reading as its yardstick."""

from wmbench.spans import per_step_ms, program_spans, self_ns


def read(ctx):
    spans = program_spans("pipeline.")
    if spans is None:
        return None
    return per_step_ms(ctx, self_ns(spans, "pipeline.", "kernels."))
