"""Closed loop of bulk steps: embed into a batch, then detect the marked
batch (upstream's ``loops_for_test`` mode, batched).

Parameters: ``batch`` frames a step, a ``ring`` of distinct batches that
stay on the card and are taken in turn, ``impl``, ``warmup_steps``;
``enqueue_steps``, ``enqueue_rounds`` and ``trace_seconds`` for the traced
run (the host's time to enqueue ``enqueue_steps`` steps with no
synchronize, the median of ``enqueue_rounds`` rounds, before the profiler
starts). A step is
``batch_embed(frames, frames, W, sf, mask, p, impl)`` then ``batch_detect``
of the marked frames, the calls of ``models/batched.py``. The strengths
and correlations of a sample of the steps drawn from the seed, one in
``KEEP_ONE_IN``, are kept for the check, and the marked batch of each ring
slot's last step; the others are dropped as a bulk job drops them, so
that the check does not fill the collector with tens of thousands of live
tensors that no deployment holds.
"""

from __future__ import annotations

import statistics
import time

import torch

from watermarking_gpu_tpu_torch.models import batch_detect, batch_embed

from .. import inputs
from ..harness import closed_loop, synchronize, traced
from ..reference import plain
from . import inputs_ready

KEEP_ONE_IN = 16
SAMPLE_STEPS = 1 << 20      # the sample's pattern repeats past this


class Cell:
    def __init__(self, ctx):
        config, params = ctx.config, ctx.params
        self.mask, self.p = config["mask"], config["p"]
        self.psnr, self.impl = config["psnr"], params["impl"]
        self.batch, self.ring = params["batch"], params["ring"]
        rows, cols = config["rows"], config["cols"]
        self.frames = inputs.frames(ctx.seed, self.ring * self.batch, rows,
                                    cols, ctx.device).view(
            self.ring, self.batch, rows, cols)
        self.batches = list(self.frames)    # the ring's views, made once
        self.watermark = inputs.watermark(ctx.seed, rows, cols, ctx.device)
        self.sf = plain.strength_factor(self.psnr)
        self.keep = (inputs.host_rng(ctx.seed, "sample").random(SAMPLE_STEPS)
                     * KEEP_ONE_IN < 1.0).tolist()
        inputs_ready(ctx)
        self.steps = 0
        self.slots, self.strengths, self.corrs = [], [], []
        self.last: dict[int, torch.Tensor] = {}
        for _ in range(params["warmup_steps"]):
            self.step()
        synchronize(ctx.device)
        self.warmup_steps = self.steps
        self.slots, self.strengths, self.corrs = [], [], []
        self.last = {}

    def step(self) -> None:
        slot = self.steps % self.ring
        frames = self.batches[slot]
        marked, strength = batch_embed(frames, frames, self.watermark,
                                       self.sf, self.mask, p=self.p,
                                       impl=self.impl)
        corr = batch_detect(marked, self.watermark, self.mask, p=self.p,
                            impl=self.impl)
        if self.keep[self.steps % SAMPLE_STEPS] or not self.slots:
            self.slots.append(slot)
            self.strengths.append(strength)
            self.corrs.append(corr)
        self.steps += 1
        self.last[slot] = marked

    def run(self, ctx) -> None:
        if not ctx.trace:
            closed_loop(ctx, self.step, ctx.seconds)
        else:
            count = ctx.params["enqueue_steps"]
            rounds = []
            for _ in range(ctx.params["enqueue_rounds"]):
                start = time.perf_counter()
                for _ in range(count):
                    self.step()
                rounds.append(time.perf_counter() - start)
                synchronize(ctx.device)
            ctx.spans["enqueue"] = (statistics.median(rounds), count)
            traced(ctx, lambda: closed_loop(
                ctx, self.step, min(ctx.seconds, ctx.params["trace_seconds"])))
        ctx.counters["frames"] = self.batch * ctx.spans["window"][1]
        ctx.attempted = self.batch * (self.steps - self.warmup_steps)

    def answers(self) -> dict:
        return {"marked": [self.last.get(slot) for slot in range(self.ring)],
                "slots": torch.tensor(self.slots, dtype=torch.long),
                "strengths": torch.stack(self.strengths).cpu(),
                "corrs": torch.stack(self.corrs).cpu()}

    def release(self) -> None:
        self.strengths = self.corrs = None

    def expected(self, dtype: torch.dtype) -> dict:
        """The reference's answers, one step a ring slot, in ``dtype``."""
        flat = self.frames.reshape(-1, *self.frames.shape[-2:])
        marked, strengths = plain.embed(flat, self.watermark, self.psnr,
                                        self.p, dtype)
        corrs = plain.detect(marked, self.watermark, self.p, dtype)
        shape = (self.ring, self.batch)
        return {"marked": list(marked.view(*shape, *marked.shape[-2:])),
                "slots": torch.arange(self.ring),
                "strengths": strengths.view(shape).cpu(),
                "corrs": corrs.view(shape).cpu()}

    @staticmethod
    def compare(got: dict, want: dict) -> dict:
        """The widest gaps: pixels of each slot's marked batch, strengths
        relative, correlations, over every sampled step."""
        if any(batch is None for batch in got["marked"]):
            return {"pixel_abs": float("inf")}
        pixel = max(float((g.double() - w.double()).abs().max())
                    for g, w in zip(got["marked"], want["marked"]))
        ref_strength = want["strengths"].double()[got["slots"]]
        ref_corr = want["corrs"].double()[got["slots"]]
        strength = ((got["strengths"].double() - ref_strength).abs()
                    / ref_strength.abs()).max()
        corr = (got["corrs"].double() - ref_corr).abs().max()
        return {"pixel_abs": pixel, "strength_rel": float(strength),
                "corr_abs": float(corr)}
