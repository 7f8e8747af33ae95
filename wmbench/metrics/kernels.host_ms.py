"""Host ms a bulk step inside the kernel wrappers (``ops/cuda/*.py``: their
checks, allocations and ctypes launches): the outermost ``kernels.*`` spans
over the traced window's steps (program spans); read by
``kernels.host_ms.<tag>``.

Read with the profiler on, so the value includes the profiler's cost of
recording the aten ops the wrappers call (about 0.52 against 0.30 ms a
1080p step on the H100 under ``utils.profiling.recording()`` alone; PERF.md
§6). A change that removes aten ops from a wrapper gains here partly by
that cost: it should cite a ``recording()`` reading as its yardstick."""

from wmbench.spans import duration_ns, outermost, per_step_ms, program_spans


def read(ctx):
    spans = program_spans("kernels.")
    if spans is None:
        return None
    return per_step_ms(ctx, duration_ns(outermost(spans, "kernels.")))
