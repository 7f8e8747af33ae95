"""Open loop of single-frame requests to one of the port's services.

Parameters: ``service`` ("detect": ``DetectorService``), its ``batch``,
``max_inflight``, ``flush_ms`` and ``max_queued``; a ``pool`` of distinct
frames in host memory in ``dtype`` (uint8 lumas, as uploads arrive), half
of them marked with the watermark by the plain reference (whose time
the set-up leaves out); ``rate_per_s``
of Poisson arrivals (``inputs.poisson_dues``) and the frame of each request
drawn from the seed; ``drain_s``, how long past the window's close an
answer may still come; ``trace_seconds`` for the traced run.

Each request is submitted when it is due with ``timeout=0``: a refused one
counts as failed and as missing any latency limit. Its latency runs from
when it was due to when its future resolved. How late the generator
submitted is reported beside the metrics.
"""

from __future__ import annotations

import functools
import queue
import threading
import time

import numpy as np
import torch

from watermarking_gpu_tpu_torch import DetectorService
from watermarking_gpu_tpu_torch.models import BatchedWatermark

from .. import inputs
from ..harness import reference_work, traced
from ..reference import plain
from . import inputs_ready

SERVICES = {"detect": DetectorService}


class Cell:
    def __init__(self, ctx):
        config, params = ctx.config, ctx.params
        self.p, self.mask = config["p"], config["mask"]
        rows, cols = config["rows"], config["cols"]
        self.params = params
        count = params["pool"]
        frames = inputs.frames(ctx.seed, count, rows, cols, ctx.device)
        self.watermark = inputs.watermark(ctx.seed, rows, cols, ctx.device)
        rng = inputs.host_rng(ctx.seed, "choice")
        marked = rng.choice(count, count // 2, replace=False)
        with reference_work(ctx):
            for index in marked.tolist():
                frames[index] = plain.embed(frames[index:index + 1],
                                            self.watermark, config["psnr"],
                                            self.p)[0][0].float()
        self.pool = frames.to(getattr(torch, params["dtype"])).cpu().numpy()
        del frames
        inputs_ready(ctx)
        self.engine = BatchedWatermark(rows, cols, self.watermark, p=self.p,
                                       psnr=config["psnr"],
                                       impl=params["impl"],
                                       device=ctx.device)
        self.service = SERVICES[params["service"]](
            self.engine, self.mask, batch_size=params["batch"],
            max_inflight=params["max_inflight"],
            flush_timeout=params["flush_ms"] / 1e3,
            max_queued=params["max_queued"])
        self.service.warmup(dtypes=(self.pool.dtype.type,))

    def _done(self, index: int, future) -> None:
        """A request's answer, in the thread that resolved it: the time,
        and the correlation or nothing. The future itself is not kept."""
        self.finished[index] = time.perf_counter()
        if future.exception() is None:
            self.corrs[index] = future.result()
        with self.lock:
            self.outstanding -= 1
            if self.outstanding == 0 and self.closing:
                self.drained.set()

    def _loop(self, ctx, seconds: float) -> None:
        dues = inputs.poisson_dues(ctx.seed, self.params["rate_per_s"],
                                   seconds)
        self.order = inputs.host_rng(ctx.seed, "order").integers(
            len(self.pool), size=len(dues))
        self.finished = np.full(len(dues), np.nan)
        self.corrs = np.full(len(dues), np.nan)
        self.accepted = np.zeros(len(dues), dtype=bool)
        self.lock = threading.Lock()
        self.outstanding, self.closing = 0, False
        self.drained = threading.Event()
        late = np.zeros(len(dues))
        start = time.perf_counter() + 0.01
        for index, due in enumerate(dues):
            delay = start + due - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            late[index] = time.perf_counter() - start - due
            try:
                future = self.service.submit(self.pool[self.order[index]],
                                             timeout=0)
            except queue.Full:
                continue
            self.accepted[index] = True
            with self.lock:
                self.outstanding += 1
            future.add_done_callback(functools.partial(self._done, index))
        delay = start + seconds - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        with self.lock:
            self.closing = True
            if self.outstanding == 0:
                self.drained.set()
        self.drained.wait(timeout=max(0.0, start + seconds
                                      + self.params["drain_s"]
                                      - time.perf_counter()))
        ended = time.perf_counter()
        with self.lock:      # answers that come later are not counted
            answered = self.accepted & ~np.isnan(self.corrs)
            finished = np.where(answered, self.finished, ended)
        ctx.latencies_s = finished - (start + dues)
        ctx.spans["window"] = (seconds, len(dues))
        ctx.attempted = len(dues)
        ctx.failed = int((~answered).sum())
        ctx.extra["generator"] = {
            "late_p95_ms": float(np.percentile(late, 95) * 1e3),
            "late_max_ms": float(late.max() * 1e3),
            "refused": int((~self.accepted).sum())}
        self.answered = answered

    def run(self, ctx) -> None:
        before = self.service.stats()
        seconds = (min(ctx.seconds, self.params["trace_seconds"])
                   if ctx.trace else ctx.seconds)
        if ctx.trace:
            traced(ctx, lambda: self._loop(ctx, seconds))
        else:
            self._loop(ctx, seconds)
        after = self.service.stats()
        batches = after["batches"] - before["batches"]
        size = self.params["batch"]
        ctx.counters["batches"] = batches
        ctx.counters["batched_frames"] = (
            after["mean_batch_fill"] * after["batches"] * size
            - before["mean_batch_fill"] * before["batches"] * size)
        ctx.counters["batch_latency_s"] = (
            after["mean_batch_latency_s"] * after["batches"]
            - before["mean_batch_latency_s"] * before["batches"])
        ctx.counters["batch_size"] = size

    def answers(self) -> dict:
        return {"index": self.order[self.accepted].tolist(),
                "corrs": [float(corr) if ok else None for corr, ok in
                          zip(self.corrs[self.accepted],
                              self.answered[self.accepted])]}

    def release(self) -> None:
        self.service.close(timeout=60)
        self.service = self.engine = None

    def expected(self, dtype: torch.dtype) -> dict:
        pool = torch.from_numpy(self.pool).to(self.watermark.device)
        corrs = plain.detect(pool, self.watermark, self.p, dtype).cpu()
        return {"index": list(range(len(self.pool))),
                "corrs": corrs.double().tolist()}

    @staticmethod
    def compare(got: dict, want: dict) -> dict:
        """The widest gap of an answer from the reference's for its frame,
        and the accepted requests that never got an answer."""
        ref = dict(zip(want["index"], want["corrs"]))
        gaps = [abs(corr - ref[index]) for index, corr
                in zip(got["index"], got["corrs"]) if corr is not None]
        return {"corr_abs": max(gaps, default=float("inf")),
                "missing": sum(corr is None for corr in got["corrs"])}
