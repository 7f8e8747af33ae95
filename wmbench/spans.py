"""What the span readers share: the program's spans, read in the same
process after the traced window (``utils.profiling.spans()`` of the port),
and the time a layer's spans take.

A program without the span recorder, or a window in which it recorded
nothing, gives None, and so does each reader.

The store holds the spans of the whole process. In a run of the harness
only the traced window records (the recorder is off without the profiler,
through set-up and the enqueue rounds), so the store is that window's. The
serving spans' request and batch ids are unique in the process, so the
serving readers' joins never pair two services' spans."""

from __future__ import annotations


def program_spans(prefix: str = "") -> list | None:
    """The recorded spans, or None where the program has no recorder or
    none of its spans' names starts with ``prefix``."""
    try:
        from watermarking_gpu_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "spans", None)
    if read is None:
        return None
    spans = read().spans
    if not any(span.name.startswith(prefix) for span in spans):
        return None
    return spans


def outermost(spans: list, prefix: str) -> list:
    """The spans of a layer (names that start with ``prefix``) that no
    span of the same layer encloses."""
    own = [span for span in spans if span.name.startswith(prefix)]
    ids = {span.id for span in own}
    return [span for span in own if span.parent not in ids]


def duration_ns(spans) -> int:
    return sum(span.end_ns - span.start_ns for span in spans)


def self_ns(spans: list, prefix: str, inner: str) -> int:
    """Time in the layer's outermost spans less the time in their direct
    children of the ``inner`` layer."""
    own = outermost(spans, prefix)
    ids = {span.id for span in own}
    children = [span for span in spans
                if span.name.startswith(inner) and span.parent in ids]
    return duration_ns(own) - duration_ns(children)


def per_step_ms(ctx, ns: int) -> float | None:
    """ms a step of the traced window (its closed loop's calls)."""
    steps = ctx.spans.get("window", (0.0, 0))[1]
    return ns / 1e6 / steps if steps else None
