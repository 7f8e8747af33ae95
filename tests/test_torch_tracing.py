"""The port's span recorder (``utils/profiling.py``) on the CPU: off, a span
records nothing and enters no ``record_function``; under the profiler or
``recording()`` the engine, pipeline and kernel spans nest, a service's
request and batch spans share their ids and lie in time order, the store's
stamps sit on the profiler's clock, the store drops its oldest spans past
its bound, and ``trace`` writes the dispatcher's spans into the profiler's
Chrome trace."""

import json
import threading
import tracemalloc
from unittest import mock

import numpy as np
import pytest
import torch
from torch.autograd import profiler as autograd_profiler

from watermarking_gpu_tpu_torch import DetectorService
from watermarking_gpu_tpu_torch.models import BatchedWatermark
from watermarking_gpu_tpu_torch.utils import profiling

torch.set_num_threads(1)

CPU_ONLY = [torch.profiler.ProfilerActivity.CPU]


@pytest.fixture(scope="module")
def engine():
    rng = np.random.default_rng(22)
    wm = rng.normal(size=(64, 64)).astype(np.float32)
    return BatchedWatermark(64, 64, wm, p=3, impl="cuda", device="cpu")


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(2222)
    return np.clip(rng.normal(128, 40, (10, 64, 64)), 0,
                   255).astype(np.uint8)


def new_spans(since: int) -> list:
    return [span for span in profiling.spans().spans if span.id > since]


def last_id() -> int:
    return max((span.id for span in profiling.spans().spans), default=0)


def test_the_flag_is_process_wide():
    """The recorder reads ``torch.autograd.profiler._is_profiler_enabled``:
    set by a profiler session for every thread, cleared after it; a span's
    parent is the innermost open one on its thread unless it names one."""
    assert not autograd_profiler._is_profiler_enabled
    assert not profiling.on()
    seen = []
    with torch.profiler.profile(activities=CPU_ONLY):
        thread = threading.Thread(target=lambda: seen.append(
            (autograd_profiler._is_profiler_enabled, profiling.on())))
        thread.start()
        thread.join(timeout=30)
        assert profiling.on()
    assert seen == [(True, True)]
    assert not autograd_profiler._is_profiler_enabled
    assert not profiling.on()
    with profiling.recording():
        assert profiling.on()
        outer = profiling.begin("tracing.outer")
        named = profiling.begin("tracing.named", parent=7)
        inner = profiling.begin("tracing.inner")
        for span in (inner, named, outer):
            span.end()
    assert not profiling.on()
    parents = {span.name: (span.parent, span.id) for span in
               profiling.spans().spans[-3:]}
    assert parents["tracing.named"][0] == 7
    assert parents["tracing.inner"][0] == parents["tracing.named"][1]
    assert parents["tracing.outer"][0] is None


def test_off_records_nothing_and_enters_no_record_function(engine,
                                                           monkeypatch):
    function = mock.MagicMock()
    monkeypatch.setattr(autograd_profiler, "record_function", function)
    before = profiling.spans()
    frames = torch.rand(2, 64, 64) * 255
    marked, _ = engine.embed(frames)
    engine.detect(marked)
    with profiling.annotate("off", batch=1):
        profiling.record("off", profiling.stamp())
    after = profiling.spans()
    function.assert_not_called()
    assert after == before
    assert profiling.begin("off", request=2) is None
    with pytest.raises(KeyError):        # an exception passes through
        with profiling.annotate("off"):
            raise KeyError("passes")


def test_an_off_span_allocates_nothing():
    """The form the program's paths use."""
    def spans(count):
        for _ in range(count):
            span = profiling.begin("kernels.off")
            try:
                pass
            finally:
                if span:
                    span.end()
    assert profiling.begin("kernels.off", batch=1) is None
    spans(100)
    tracemalloc.start()
    try:
        spans(10_000)
        current, _ = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert current < 4096     # a span object each would be ~1 MB


@pytest.mark.parametrize("door", ["profiler", "recording"])
def test_engine_pipeline_and_kernel_spans_nest(engine, door):
    since = last_id()
    frames = torch.rand(2, 64, 64) * 255
    section = (torch.profiler.profile(activities=CPU_ONLY)
               if door == "profiler" else profiling.recording())
    with section:
        marked, _ = engine.embed(frames)
        engine.detect(marked)
    spans = new_spans(since)
    by_id = {span.id: span for span in spans}
    children = {}
    for span in spans:
        children.setdefault(span.parent, []).append(span.name)
    roots = [span for span in spans if span.parent not in by_id]
    assert [span.name for span in roots] == [
        "engine.to_device", "engine.embed", "engine.to_device",
        "engine.detect"]
    _, embed, _, detect = roots
    assert children[embed.id] == ["pipeline.embed"]
    assert children[detect.id] == ["pipeline.detect"]
    pipeline_embed = next(span for span in spans
                          if span.name == "pipeline.embed")
    pipeline_detect = next(span for span in spans
                           if span.name == "pipeline.detect")
    assert children[pipeline_embed.id] == [
        "kernels.me_gram_solve8", "kernels.embed_field",
        "kernels.embed_finish"]
    assert children[pipeline_detect.id] == [
        "kernels.me_gram_solve8", "kernels.detect_partials"]
    for span in spans:
        assert span.start_ns <= span.end_ns
        assert span.thread == threading.get_native_id()
        assert span.scoped
        assert span.profiled == (door == "profiler")
        if span.parent in by_id:
            parent = by_id[span.parent]
            assert parent.start_ns <= span.start_ns <= span.end_ns \
                <= parent.end_ns


@pytest.mark.parametrize("door", ["profiler", "recording"])
def test_service_spans_share_ids_and_lie_in_order(engine, frames, door):
    since = last_id()
    section = (torch.profiler.profile(activities=CPU_ONLY)
               if door == "profiler" else profiling.recording())
    with section:
        service = DetectorService(engine, batch_size=4, flush_timeout=0.002)
        try:
            futures = [service.submit(frame) for frame in frames]
            answers = [future.result(timeout=60) for future in futures]
        finally:
            assert service.close(timeout=60)
    assert len(answers) == len(frames)
    spans = new_spans(since)
    requests = {span.request: span for span in spans
                if span.name == "serving.request"}
    assert len(requests) == len(frames)
    gathers = {span.batch: span for span in spans
               if span.name == "serving.gather"}
    assert sorted(r for gather in gathers.values()
                  for r in gather.requests) == sorted(requests)
    batches = {}
    for span in spans:
        if span.name in ("serving.stage", "serving.inflight",
                         "serving.collect"):
            batches.setdefault(span.batch, {})[span.name] = span
    assert sorted(batches) == sorted(gathers)
    dispatcher = service._dispatcher.native_id
    collector = service._collector.native_id
    for batch, gather in gathers.items():
        stage = batches[batch]["serving.stage"]
        inflight = batches[batch]["serving.inflight"]
        collect = batches[batch]["serving.collect"]
        assert gather.thread == stage.thread == dispatcher
        assert inflight.thread == collect.thread == collector
        assert (gather.start_ns <= gather.end_ns <= stage.start_ns
                <= stage.end_ns <= inflight.start_ns <= inflight.end_ns
                <= collect.start_ns <= collect.end_ns)
        assert requests[gather.requests[0]].start_ns <= gather.start_ns
        for request in gather.requests:
            span = requests[request]
            assert span.start_ns <= gather.end_ns
            assert stage.start_ns >= span.start_ns
            assert collect.end_ns <= span.end_ns
        engine_spans = [span for span in spans if span.parent == stage.id]
        assert [span.name for span in engine_spans] == ["engine.to_device",
                                                        "engine.detect"]


def test_two_services_never_share_an_id(engine, frames):
    """Request and batch ids are unique in the process, so a reader that
    joins the store's spans by id never pairs two services' spans."""
    since = last_id()
    with profiling.recording():
        for _ in range(2):
            service = DetectorService(engine, batch_size=4,
                                      flush_timeout=0.002)
            try:
                [future.result(timeout=60)
                 for future in [service.submit(frame)
                                for frame in frames[:5]]]
            finally:
                assert service.close(timeout=60)
    spans = new_spans(since)
    requests = [span.request for span in spans
                if span.name == "serving.request"]
    batches = [span.batch for span in spans if span.name == "serving.stage"]
    assert len(requests) == len(set(requests)) == 10
    assert len(batches) == len(set(batches)) >= 4


def test_stamps_are_on_the_profilers_clock():
    since = last_id()
    with torch.profiler.profile(activities=CPU_ONLY) as prof:
        with profiling.annotate("tracing.clock_check"):
            torch.square(torch.arange(8.0))
    span, = [span for span in new_spans(since)
             if span.name == "tracing.clock_check"]
    assert span.profiled
    events = [event for event in prof.profiler.kineto_results.events()
              if event.name() == "tracing.clock_check"]
    assert len(events) == 1
    assert abs(events[0].start_ns() - span.start_ns) < 1_000_000
    assert abs(events[0].start_ns() + events[0].duration_ns()
               - span.end_ns) < 1_000_000


def test_the_store_drops_its_oldest_spans_and_counts_them():
    before = profiling.spans()
    extra = 5
    with profiling.recording():
        for index in range(profiling.CAPACITY + extra):
            with profiling.annotate("tracing.fill", request=index):
                pass
    after = profiling.spans()
    assert len(after.spans) == profiling.CAPACITY
    assert after.dropped - before.dropped == len(before.spans) + extra
    assert [span.request for span in after.spans] == list(
        range(extra, profiling.CAPACITY + extra))


def test_trace_holds_the_dispatchers_spans(engine, frames, tmp_path):
    log_dir = tmp_path / "trace"
    with profiling.trace(str(log_dir)):
        service = DetectorService(engine, batch_size=4, flush_timeout=0.002)
        try:
            futures = [service.submit(frame) for frame in frames[:4]]
            [future.result(timeout=60) for future in futures]
        finally:
            assert service.close(timeout=60)
    path, = log_dir.glob("trace_*.json")
    events = json.loads(path.read_text())["traceEvents"]
    profiled = [event for event in events
                if event.get("ph") == "X" and event.get("cat") != "span"]
    first = min(event["ts"] for event in profiled)
    last = max(event["ts"] + event["dur"] for event in profiled)
    stages = [event for event in events if event["name"] == "serving.stage"]
    assert len(stages) == 1
    stage, = stages
    assert stage["ph"] == "X"
    assert stage["tid"] == service._dispatcher.native_id
    assert stage["tid"] != threading.get_native_id()
    assert first <= stage["ts"] <= stage["ts"] + stage["dur"] <= last
    requests = [event for event in events
                if event["name"] == "serving.request"]
    assert sorted(event["ph"] for event in requests) == ["b"] * 4 + ["e"] * 4
