"""The device trace of a traced run, reduced to what the readers need.

``capture()`` wraps the traced window in ``torch.profiler`` (CPU and CUDA
activities); ``summarize`` reduces its records to the device's busy time
(the union of the device intervals), the traced window (the span of every
record), each device operation's count and seconds, and the idle gaps
between device intervals, each labelled by what the host was doing at the
gap's middle: the innermost host record that covers it, on any thread, or
``host: no traced op`` where none does (Python between calls, a sleep, a
queue wait). ``tools/profile_torch_step.py`` sums the kernels' device time
for its busy time; on one stream the union is the same.
"""

from __future__ import annotations

import contextlib
import heapq
import time

import torch

# device records that are copies or fills, not kernels
_NOT_KERNELS = ("Memcpy", "Memset")
NO_OP = "host: no traced op"
TOP = 10


@contextlib.contextmanager
def capture():
    """Profile the enclosed window; yields a dict that holds the profiler
    (``"prof"``) and the host clock's window (``"host_s"``) once the block
    has ended."""
    out: dict = {}
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        start = time.perf_counter()
        yield out
        out["host_s"] = time.perf_counter() - start
    out["prof"] = prof


def records(prof) -> tuple[list, list]:
    """(device records, host records) of a finished profiler, each a list of
    (start ns, end ns, name)."""
    device, host = [], []
    cuda = torch.autograd.DeviceType.CUDA
    for event in prof.profiler.kineto_results.events():
        start = event.start_ns()
        item = (start, start + event.duration_ns(), event.name())
        (device if event.device_type() == cuda else host).append(item)
    return device, host


def _merged(intervals: list) -> list:
    merged: list = []
    for start, end, _ in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def _label_gaps(gaps: list, host: list) -> list:
    """Each (start, end) gap's label: the shortest host record covering its
    middle (a sweep over the middles in order, host records pushed by start
    into a heap keyed by duration, those ended dropped from its top)."""
    order = sorted(range(len(gaps)), key=lambda i: gaps[i][0] + gaps[i][1])
    by_start = sorted(host)
    heap: list = []
    labels = [NO_OP] * len(gaps)
    next_host = 0
    for index in order:
        middle = (gaps[index][0] + gaps[index][1]) / 2
        while next_host < len(by_start) and by_start[next_host][0] <= middle:
            start, end, name = by_start[next_host]
            heapq.heappush(heap, (end - start, end, name))
            next_host += 1
        while heap and heap[0][1] < middle:
            heapq.heappop(heap)
        if heap:
            labels[index] = heap[0][2]
    return labels


def _top(totals: dict) -> list:
    ranked = sorted(totals.items(), key=lambda item: -item[1])[:TOP]
    return [[name[:160], seconds] for name, seconds in ranked]


def summarize(device: list, host: list, host_s: float = 0.0) -> dict:
    """Busy and window seconds, per-name device operations, and the idle
    gaps by host activity, from (start ns, end ns, name) records."""
    everything = device + host
    if not everything:
        return {"busy_s": 0.0, "window_s": host_s, "ops": {},
                "breakdown": {"device_ops": [], "idle_gaps": []}}
    first = min(item[0] for item in everything)
    last = max(item[1] for item in everything)
    merged = _merged(device)
    busy_ns = sum(end - start for start, end in merged)
    edges = [first] + [x for pair in merged for x in pair] + [last]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    idle: dict = {}
    for (start, end), label in zip(gaps, _label_gaps(gaps, host)):
        idle[label] = idle.get(label, 0.0) + (end - start) / 1e9
    ops: dict = {}
    for start, end, name in device:
        count, seconds = ops.get(name, (0, 0.0))
        ops[name] = (count + 1, seconds + (end - start) / 1e9)
    return {"busy_s": busy_ns / 1e9,
            "window_s": max((last - first) / 1e9, host_s),
            "ops": ops,
            "breakdown": {"device_ops": _top({name: seconds for name,
                                              (_, seconds) in ops.items()}),
                          "idle_gaps": _top(idle)}}


def kernels(summary: dict, pattern: str = "") -> tuple[int, float]:
    """(launches, device seconds) of the kernels whose name holds
    ``pattern`` (every kernel for ""; copies and fills are not kernels)."""
    count, seconds = 0, 0.0
    for name, (n, s) in summary["ops"].items():
        if pattern in name and not name.startswith(_NOT_KERNELS):
            count += n
            seconds += s
    return count, seconds
