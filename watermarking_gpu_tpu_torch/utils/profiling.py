"""Profiling hooks.

The reference's only observability is wall-clock prints; the port, as the
JAX package does with ``jax.profiler``, adds an optional profiler trace
around any section: ``torch.profiler`` with CPU and, where there is a card,
CUDA activities, exported as a Chrome trace (open it in Perfetto or
``chrome://tracing``).
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(log_dir: str | os.PathLike | None):
    """Capture a ``torch.profiler`` trace of the section into ``log_dir``
    as ``trace_<pid>_<ns>.json`` (no-op when ``log_dir`` is falsy)."""
    if not log_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


@contextlib.contextmanager
def annotate(name: str):
    """Named span that shows up in profiler timelines: a
    ``record_function`` range, and an NVTX range where there is a card."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()
