"""One run of one cell: set-up, the measured window, the check, the result.

Everything a cell is made of is found by name from ``BENCHMARK.json``, so a
later cell, configuration, traffic mix or metric is a new file and a new
entry, never an edit:

* the configuration: ``wmbench/configs/<config>.json`` (mask, p, PSNR, the
  frame's size);
* the traffic mix: ``wmbench/traffic/<traffic>.json``, parameters that name
  their loop, ``kind``, a module ``wmbench/traffic/<kind>.py``;
* the cell: ``wmbench/cells/<workload>.json``, parameters that override
  the mix's for this cell (a rate, the limits of its check);
* each metric: ``wmbench/metrics/<metric>.py``, whose ``read(ctx)`` returns
  the metric's value or None where the run has nothing to read; a metric
  split by configuration, ``<stem>.<tag>``, with no file of its own reads
  with ``metrics/<stem>.py``;
* each operation's work: ``wmbench/work/<op>.py``.

A kind's module has a class ``Cell``: ``Cell(ctx)`` makes the inputs from
the seed and warms up the program (the set-up); ``run(ctx)`` drives the
window and fills the context's spans, counters and trace; ``answers()``
returns what the program produced; ``release()`` frees the program's
state; ``expected(dtype)`` works the same answers out with the plain
reference in ``dtype``; ``compare(got, want)`` returns the numbers that
the cell's ``limits`` hold.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

import torch

from . import trace as tracing
from . import work

ROOT = Path(__file__).resolve().parents[1]
BENCH_DIR = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "watermarking_gpu_tpu")


def forbidden_modules(modules=None) -> list[str]:
    """Top-level names in ``sys.modules`` that the port must not load,
    compared whole (``watermarking_gpu_tpu_torch`` is not
    ``watermarking_gpu_tpu``)."""
    names = sys.modules if modules is None else modules
    return sorted({name.split(".")[0] for name in names} & set(FORBIDDEN))


def load_json(path: Path) -> dict:
    with open(path) as handle:
        return json.load(handle)


class Context:
    """What one run knows: its cell, inputs' sizes, and what it measured."""

    def __init__(self, manifest: dict, workload: str, seed: int,
                 seconds: float, trace: bool, device: torch.device,
                 bench_dir: Path = BENCH_DIR, overrides: dict | None = None):
        cells = {cell["name"]: cell for cell in manifest["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        self.workload = cells[workload]
        configs = {config["name"]: config for config in manifest["configs"]}
        self.config = load_json(bench_dir.parent
                                / configs[self.workload["config"]]["file"])
        self.params = load_json(bench_dir / "traffic"
                                / f"{self.workload['traffic']}.json")
        cell_file = bench_dir / "cells" / f"{workload}.json"
        if cell_file.is_file():
            self.params.update(load_json(cell_file))
        for key, value in (overrides or {}).items():
            (self.config if key in self.config else self.params)[key] = value
        self.manifest = manifest
        self.bench_dir = bench_dir
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = device
        self.device_name = (torch.cuda.get_device_name(device)
                            if device.type == "cuda" else "cpu")
        self.setup_s = math.nan
        self.reference_s = 0.0                # the reference's, in set-up
        self.attempted = 0
        self.failed = 0
        self.spans: dict[str, tuple[float, int]] = {}   # name: (s, count)
        self.counters: dict[str, float] = {}
        self.latencies_s = None
        self.summary: dict | None = None      # the trace, reduced
        self.marks: dict[str, float] = {}     # host clock, set-up's phases
        self.extra: dict = {}

    def work(self) -> tuple[float, float]:
        """(bytes, flops) of one call of the cell's operation."""
        return work.counts(self.params["work"], self.config, self.params)

    def metrics(self) -> list[dict]:
        """The manifest's metrics for this cell and mode: the end-to-end
        ones in a plain run, the per-layer ones in a traced run."""
        group = self.manifest["per_layer" if self.trace else "end_to_end"]
        name = self.workload["name"]
        return [metric for metric in group
                if name in metric.get("workloads", [name])]


def reader(bench_dir: Path, name: str):
    """The ``read`` function of ``<bench>/metrics/<name>.py``, or, where
    that is absent, of its stem's: ``step_fps.1080p`` reads with
    ``metrics/step_fps.py``."""
    path = bench_dir / "metrics" / f"{name}.py"
    if not path.is_file() and "." in name:
        path = bench_dir / "metrics" / f"{name.rsplit('.', 1)[0]}.py"
    spec = importlib.util.spec_from_file_location(
        f"{bench_dir.name}.metrics.{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def kind(params: dict):
    return importlib.import_module(f"{__package__}.traffic."
                                   f"{params['kind']}")


def check_numbers(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): every limited number present,
    finite and at most its limit."""
    checks, correct = {}, True
    for name, limit in limits.items():
        value = numbers.get(name, math.nan)
        value = float(value)
        checks[name] = {"value": value, "limit": limit}
        if not (math.isfinite(value) and value <= limit):
            correct = False
    return correct, checks


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def memory_peak(device: torch.device) -> int:
    return (int(torch.cuda.max_memory_allocated(device))
            if device.type == "cuda" else 0)


@contextlib.contextmanager
def reference_work(ctx: Context):
    """Time the plain reference's work inside the set-up (marking inputs
    with a watermark), which ``setup_s`` leaves out: no change to the
    program can move it."""
    synchronize(ctx.device)
    start = time.perf_counter()
    try:
        yield
    finally:
        synchronize(ctx.device)
        ctx.reference_s += time.perf_counter() - start


class GcPauses:
    """The collector's pauses while registered in ``gc.callbacks``: their
    total and the longest, in ms, and the collections of each generation."""

    def __init__(self):
        self.total_ms = self.longest_ms = 0.0
        self.collections = [0, 0, 0]
        self._start = None

    def __call__(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._start = time.perf_counter()
        elif self._start is not None:
            pause = 1e3 * (time.perf_counter() - self._start)
            self.total_ms += pause
            self.longest_ms = max(self.longest_ms, pause)
            self.collections[info["generation"]] += 1
            self._start = None

    def report(self) -> dict:
        return {"collections": self.collections, "pause_ms": self.total_ms,
                "longest_ms": self.longest_ms}


def host_probe_ms(loops: int = 200_000) -> float:
    """ms of a fixed pure-Python loop, taken just before and after the
    window: the host's speed at Python, which paces a step whose host
    enqueues slower than the card runs, and which a shared host varies."""
    start = time.perf_counter()
    total = 0
    for index in range(loops):
        total += index & 7
    return 1e3 * (time.perf_counter() - start)


def run(ctx: Context, started: float) -> dict:
    """Set up, measure, check; the result's dict (``checks`` last)."""
    ctx.marks["cell"] = time.perf_counter()
    cell = kind(ctx.params).Cell(ctx)
    synchronize(ctx.device)
    gc.collect()        # the set-up's garbage; nothing is frozen
    ready = time.perf_counter()
    ctx.setup_s = ready - started - ctx.reference_s
    inputs = ctx.marks.get("inputs", ctx.marks["cell"])
    ctx.extra["setup_phases_s"] = {
        "start": ctx.marks["cell"] - started,
        "inputs": inputs - ctx.marks["cell"] - ctx.reference_s,
        "reference": ctx.reference_s, "program": ready - inputs}
    probes = [host_probe_ms()]
    pauses = GcPauses()
    gc.callbacks.append(pauses)
    try:
        cell.run(ctx)
        synchronize(ctx.device)
    finally:
        gc.callbacks.remove(pauses)
    probes.append(host_probe_ms())
    ctx.extra["gc"] = pauses.report()
    ctx.extra["host_probe_ms"] = probes
    peak = memory_peak(ctx.device)
    got = cell.answers()
    cell.release()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = cell.compare(got, cell.expected(torch.float64))
    correct, checks = check_numbers(numbers, ctx.params["limits"])
    metrics = {}
    for metric in ctx.metrics():
        value = reader(ctx.bench_dir, metric["name"])(ctx)
        if value is not None:
            metrics[metric["name"]] = {"value": float(value),
                                       "unit": metric["unit"]}
    device = {"platform": "gpu" if ctx.device.type == "cuda" else "cpu",
              "kind": ctx.device_name, "count": 1,
              "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": ctx.attempted,
              "failed": ctx.failed, "metrics": metrics, "device": device}
    if ctx.summary is not None:
        device["busy_s"] = ctx.summary["busy_s"]
        device["window_s"] = ctx.summary["window_s"]
        result["breakdown"] = ctx.summary["breakdown"]
    result.update(ctx.extra)
    result["checks"] = checks
    return result


def closed_loop(ctx: Context, call, seconds: float) -> None:
    """Call ``call()`` back to back for ``seconds``, then synchronize: the
    window's span (seconds, calls), and, beside the metrics, the calls of
    each whole second, which show whether a run's pace drifted."""
    calls, chunks = 0, []
    start = time.perf_counter()
    deadline, mark = start + seconds, start + 1.0
    while True:
        now = time.perf_counter()
        if now >= mark:
            chunks.append(calls - sum(chunks))
            mark += 1.0
        if now >= deadline:
            break
        call()
        calls += 1
    synchronize(ctx.device)
    ctx.spans["window"] = (time.perf_counter() - start, calls)
    ctx.extra["calls_each_second"] = chunks


def traced(ctx: Context, loop) -> None:
    """Run ``loop()`` under the profiler and keep the reduced trace."""
    with tracing.capture() as captured:
        loop()
        synchronize(ctx.device)
    device, host = tracing.records(captured["prof"])
    ctx.summary = tracing.summarize(device, host, captured["host_s"])
