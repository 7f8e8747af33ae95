"""The port's span recorder and its trace exporter.

``begin(name, ...)`` opens a span at a layer boundary and its ``end()``
closes it: ``serving.*`` (``serving.py``), ``engine.*`` (``models/``),
``pipeline.*`` (``ops/pipelines.py``) and ``kernels.*`` (the wrappers of
``ops/cuda/``). A span records only while a ``torch.profiler`` session is
active in the process, or inside ``recording()``; otherwise ``begin``
returns None after one read of the profiler's process-wide flag: no
``record_function``, no allocation. The program's paths write

    span = begin("kernels.embed_field")
    try:
        ...
    finally:
        if span:
            span.end()

because on the card's host a span that is off costs ~0.06 µs in this form
and ~0.3 µs in a ``with`` statement, whose protocol alone costs more than
the rest; ``with annotate(name): ...`` is the same span for code off the
hot paths.

A recorded span keeps its name, its start and end on the profiler's clock
(``clock_ns``), its thread, its own id, its parent's (the innermost open
span on the thread, unless the caller names one) and the request or batch
ids its caller passes. On the thread that runs the profiler it also opens a
range of that name among the profiler's host records, of the kind torch's
own operators make (a ``record_function`` range would also put a copy on
the device's timeline, among the kernels). ``stamp()`` and ``record()``
make a span that opens on one thread and closes on another (a served
request). The store keeps the newest ``CAPACITY`` spans; ``spans()``
returns a snapshot with the number of spans dropped.

``trace(log_dir)`` writes the profiler's Chrome trace of a section (open it
in Perfetto or ``chrome://tracing``), with the store's spans from threads
the profiler does not record, such as a service's dispatcher and collector,
added on their own thread rows in the trace's time base.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time
from typing import NamedTuple

import torch
from torch.autograd import profiler as _profiler

CAPACITY = 1 << 16

# kineto stamps its host and device records with the Unix time in ns
clock_ns = time.time_ns


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    thread: int                 # threading.get_native_id()
    id: int
    parent: int | None
    request: int | None = None
    batch: int | None = None
    requests: tuple | None = None   # a batch's request ids
    scoped: bool = True         # begun and ended on its thread, nested
    profiled: bool = False      # also among the profiler's host records


class Spans(NamedTuple):
    spans: list[Span]
    dropped: int


class _Store:
    """The spans of the process."""

    def __init__(self, capacity: int):
        self.lock = threading.Lock()
        self.records: collections.deque = collections.deque(maxlen=capacity)
        self.dropped = 0
        self.ids = itertools.count(1)
        self.local = threading.local()

    def add(self, span: Span) -> None:
        with self.lock:
            if len(self.records) == self.records.maxlen:
                self.dropped += 1
            self.records.append(span)

    def here(self) -> tuple[list[int], int]:
        """This thread's open spans' ids, innermost last, and its native
        id (asked of the system once a thread)."""
        local = self.local
        try:
            return local.stack, local.thread
        except AttributeError:
            local.stack, local.thread = [], threading.get_native_id()
            return local.stack, local.thread


_store = _Store(CAPACITY)
_recording = 0          # open recording() blocks, changed under _store.lock


def on() -> bool:
    """Whether spans record now."""
    return bool(_profiler._is_profiler_enabled or _recording)


class _Span:
    __slots__ = ("name", "parent", "request", "batch", "requests", "id",
                 "start_ns", "range")

    def __init__(self, name, parent, request, batch, requests):
        stack, _ = _store.here()
        self.name, self.request = name, request
        self.batch, self.requests = batch, requests
        self.id = next(_store.ids)
        self.parent = parent if parent is not None or not stack else stack[-1]
        stack.append(self.id)
        self.range = None
        if torch._C._autograd._profiler_enabled():   # this thread's
            self.range = torch._C._profiler._RecordFunctionFast(name)
            self.range.__enter__()
        self.start_ns = clock_ns()

    def end(self) -> None:
        end = clock_ns()
        if self.range is not None:
            self.range.__exit__(None, None, None)
        stack, thread = _store.here()
        stack.pop()
        _store.add(Span(self.name, self.start_ns, end, thread, self.id,
                        self.parent, self.request, self.batch, self.requests,
                        True, self.range is not None))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.end()
        return False


def begin(name: str, request: int | None = None, batch: int | None = None,
          requests: tuple | None = None,
          parent: int | None = None) -> _Span | None:
    """A span from now to its ``end()``, which this thread calls (in a
    ``finally``); None while nothing records.

    The ids are named parameters with defaults: ``**ids`` would build a
    dict on every call, and keyword-only parameters take CPython's slower
    call path (~0.14 µs a span that is off on the card's host, against
    ~0.06 µs)."""
    if not (_profiler._is_profiler_enabled or _recording):
        return None
    return _Span(name, parent, request, batch, requests)


def annotate(name: str, **ids):
    """A span over the enclosed block: ``with annotate(name): ...``, the
    ``with`` form of ``begin`` (same ids)."""
    return begin(name, **ids) or contextlib.nullcontext()


def stamp() -> int | None:
    """Now on the profiler's clock while recording, else None: the start
    of a span that ``record`` closes, on this thread or another."""
    return (clock_ns() if _profiler._is_profiler_enabled or _recording
            else None)


def record(name: str, start_ns: int | None, request: int | None = None,
           batch: int | None = None, requests: tuple | None = None,
           parent: int | None = None) -> None:
    """Record a span from ``start_ns`` (a ``stamp()``) to now, on this
    thread; nothing where ``start_ns`` is None."""
    if start_ns is None:
        return
    _store.add(Span(name, start_ns, clock_ns(), _store.here()[1],
                    next(_store.ids), parent, request, batch, requests,
                    False))


def spans() -> Spans:
    """A snapshot of the store: its spans, oldest first, and the spans
    dropped for room."""
    with _store.lock:
        return Spans(list(_store.records), _store.dropped)


@contextlib.contextmanager
def recording():
    """Record spans in the enclosed section without a profiler (a live
    service's request spans, at a span's own cost)."""
    global _recording
    with _store.lock:
        _recording += 1
    try:
        yield
    finally:
        with _store.lock:
            _recording -= 1


def _chrome_events(added: list[Span], base_ns: int) -> list[dict]:
    """Chrome trace events of spans: a ``with`` block as a complete event
    on its thread's row, a span closed by ``record`` (which may overlap its
    thread's others) as an async pair."""
    pid = os.getpid()
    events = []
    for span in added:
        args = {key: value for key, value in (
            ("id", span.id), ("parent", span.parent),
            ("request", span.request), ("batch", span.batch),
            ("requests", span.requests)) if value is not None}
        ts = (span.start_ns - base_ns) / 1e3
        common = {"name": span.name, "cat": "span", "pid": pid,
                  "tid": span.thread}
        if span.scoped:
            events.append({**common, "ph": "X", "ts": ts,
                           "dur": (span.end_ns - span.start_ns) / 1e3,
                           "args": args})
        else:
            events.append({**common, "ph": "b", "id": span.id, "ts": ts,
                           "args": args})
            events.append({**common, "ph": "e", "id": span.id,
                           "ts": (span.end_ns - base_ns) / 1e3})
    return events


@contextlib.contextmanager
def trace(log_dir: str | os.PathLike | None):
    """Capture a ``torch.profiler`` trace of the section into ``log_dir``
    as ``trace_<pid>_<ns>.json``, with the section's spans from threads the
    profiler does not record (no-op when ``log_dir`` is falsy)."""
    if not log_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    opened = clock_ns()
    with torch.profiler.profile(activities=activities) as prof:
        yield
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    added = [span for span in spans().spans
             if span.start_ns >= opened and not span.profiled]
    if not added:
        return
    with open(path) as handle:
        chrome = json.load(handle)
    chrome["traceEvents"].extend(
        _chrome_events(added, int(chrome.get("baseTimeNanoseconds", 0))))
    with open(path, "w") as handle:
        json.dump(chrome, handle)
