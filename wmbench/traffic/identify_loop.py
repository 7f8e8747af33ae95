"""Closed loop of identification: ``batch`` frames against a bank of
``candidates`` watermarks on the card (``BatchedWatermark.detect_many``).

Set-up draws the bank and the frames from the seed, and embeds a distinct
candidate into ``marked_frames`` of the frames with the plain reference
(whose time the set-up leaves out), so that each of those has one right
answer. Every (batch, candidates) result
of the window is kept.
"""

from __future__ import annotations

import torch

from watermarking_gpu_tpu_torch.models import BatchedWatermark

from .. import inputs
from ..harness import closed_loop, reference_work, synchronize, traced
from ..reference import plain
from . import inputs_ready


class Cell:
    def __init__(self, ctx):
        config, params = ctx.config, ctx.params
        self.p, self.mask = config["p"], config["mask"]
        rows, cols = config["rows"], config["cols"]
        batch, count = params["batch"], params["candidates"]
        self.bank = inputs.bank(ctx.seed, count, rows, cols, ctx.device)
        self.frames = inputs.frames(ctx.seed, batch, rows, cols, ctx.device)
        rng = inputs.host_rng(ctx.seed, "choice")
        self.marked = rng.choice(batch, params["marked_frames"],
                                 replace=False).tolist()
        self.carried = rng.choice(count, params["marked_frames"],
                                  replace=False).tolist()
        with reference_work(ctx):
            for frame, candidate in zip(self.marked, self.carried):
                self.frames[frame] = plain.embed(
                    self.frames[frame:frame + 1], self.bank[candidate],
                    config["psnr"], self.p)[0][0].float()
        inputs_ready(ctx)
        self.engine = BatchedWatermark(rows, cols, self.bank[0], p=self.p,
                                       psnr=config["psnr"],
                                       impl=params["impl"],
                                       device=ctx.device)
        self.results: list[torch.Tensor] = []
        for _ in range(params["warmup_calls"]):
            self.call()
        synchronize(ctx.device)
        self.results = []

    def call(self) -> None:
        self.results.append(self.engine.detect_many(self.frames, self.bank,
                                                    self.mask))

    def run(self, ctx) -> None:
        if ctx.trace:
            traced(ctx, lambda: closed_loop(
                ctx, self.call, min(ctx.seconds, ctx.params["trace_seconds"])))
        else:
            closed_loop(ctx, self.call, ctx.seconds)
        calls = ctx.spans["window"][1]
        ctx.counters["frames"] = self.frames.shape[0] * calls
        ctx.counters["calls"] = calls
        ctx.attempted = self.frames.shape[0] * len(self.results)

    def answers(self) -> dict:
        return {"corrs": torch.stack(self.results).cpu()}

    def release(self) -> None:
        self.results = None
        self.engine = None

    def expected(self, dtype: torch.dtype) -> dict:
        return {"corrs": plain.detect_many(self.frames, self.bank, self.p,
                                           dtype)[None].cpu()}

    def compare(self, got: dict, want: dict) -> dict:
        """The widest correlation gap over every call, and the marked
        frames whose best candidate is not the reference's."""
        corrs, ref = got["corrs"].double(), want["corrs"].double()
        winners = corrs[:, self.marked].argmax(dim=-1)
        ref_winners = ref[:, self.marked].argmax(dim=-1)
        return {"corr_abs": float((corrs - ref).abs().max()),
                "winner_miss": int((winners != ref_winners).sum())}
