"""Closed loop of whole passes of the port's video detection
(``video.pipeline.detect_video``) over a raw YUV420p clip in ``TMPDIR``:
upstream's video mode with detection on (``settings.ini``:
``watermark_interval``, ``watermark_detection = true``).

The kind detects; it embeds nothing. Parameters: ``watermark_interval``,
``detect_batch``, ``clip_frames``, ``impl``, ``warmup_passes`` and
``trace_seconds`` for the traced run.

Set-up checks that ``TMPDIR`` has twice the clip free, then draws the clip
from the seed: lumas from ``inputs.frames`` rounded to u8, and chroma
planes of seeded noise. Of the sampled frames (every
``watermark_interval``-th, from frame 0) every other one is marked with
the plain reference and truncated to u8, as upstream writes it. The clip
goes to a fresh file in ``TMPDIR``, flushed to the disk so that no
writeback runs in the window. Making, marking and writing are timed as
the reference's work, which ``setup_s`` leaves out. The clip is raw, as
upstream's decoder hands frames to the engine on its pipe, so no decode is
measured. Then one ``BatchedWatermark`` and ``warmup_passes`` passes,
which also bring the clip into the page cache.

Each call of the window is one whole pass, ``detect_video(settings,
engine=..., out=<os.devnull>, stats=...)``, as the command
line calls it. The passes' frames and ``stats`` are summed into the
context's counters under ``video.``; every pass's correlations are kept
for the check against the reference's for the sampled lumas.
``release()`` deletes the clip; the process's exit deletes it too where a
run fails before that.
"""

from __future__ import annotations

import contextlib
import math
import os
import shutil
import tempfile
import weakref

import torch

from watermarking_gpu_tpu_torch.io.config import Settings
from watermarking_gpu_tpu_torch.models import BatchedWatermark
from watermarking_gpu_tpu_torch.video import native_available
from watermarking_gpu_tpu_torch.video.pipeline import detect_video

from .. import inputs
from ..harness import closed_loop, reference_work, synchronize, traced
from ..reference import plain
from . import inputs_ready

STATS = ("read_s", "prep_s", "collect_s", "batches", "frames")
WRITE_FRAMES = 64           # frames copied to the host and written at once


def _remove(path: str) -> None:
    with contextlib.suppress(FileNotFoundError):
        os.unlink(path)


class Cell:
    def __init__(self, ctx):
        config, params = ctx.config, ctx.params
        self.p, psnr = config["p"], config["psnr"]
        rows, cols = config["rows"], config["cols"]
        self.clip_frames = params["clip_frames"]
        interval = params["watermark_interval"]
        self.sampled_ids = list(range(0, self.clip_frames, interval))
        self.watermark = inputs.watermark(ctx.seed, rows, cols, ctx.device)
        frame_bytes = rows * cols * 3 // 2
        tmpdir = tempfile.gettempdir()
        need = 2 * self.clip_frames * frame_bytes
        free = shutil.disk_usage(tmpdir).free
        if free < need:
            raise RuntimeError(
                f"TMPDIR {tmpdir} has {free} bytes free; the "
                f"{self.clip_frames}-frame clip needs twice its "
                f"{need // 2} bytes")
        fd, self.path = tempfile.mkstemp(prefix="wmbench-clip-",
                                         suffix=".yuv")
        self._remove = weakref.finalize(self, _remove, self.path)
        with reference_work(ctx), os.fdopen(fd, "wb") as clip:
            self.sampled = self._write_clip(ctx, clip, rows, cols, psnr)
            clip.flush()
            os.fsync(clip.fileno())
        inputs_ready(ctx)
        self.settings = Settings(
            video=self.path, raw_video_size=f"{cols}x{rows}", p=self.p,
            psnr=psnr, watermark_interval=interval,
            detect_batch=params["detect_batch"], watermark_detection=True)
        self.engine = BatchedWatermark(rows, cols, self.watermark, p=self.p,
                                       psnr=psnr, impl=params["impl"],
                                       device=ctx.device)
        # a pass's correlations come from its return value, not its text
        self.sink = open(os.devnull, "w")
        self._reset()
        for _ in range(params["warmup_passes"]):
            self.call()
        synchronize(ctx.device)
        self._reset()

    def _write_clip(self, ctx, clip, rows: int, cols: int,
                    psnr: float) -> torch.Tensor:
        """Draw, mark and write the clip; the sampled lumas, on the host."""
        count, device = self.clip_frames, ctx.device
        lumas = inputs.frames(ctx.seed, count, rows, cols, device)
        lumas = lumas.round_().to(torch.uint8)
        for index in self.sampled_ids[::2]:
            marked, _ = plain.embed(lumas[index:index + 1], self.watermark,
                                    psnr, self.p)
            lumas[index] = marked[0].to(torch.uint8)    # truncates
        # this cell draws no bank: its stream gives the chroma planes
        chroma = torch.randint(0, 256, (count, rows * cols // 2),
                               generator=inputs.generator(ctx.seed, "bank",
                                                          device),
                               device=device, dtype=torch.uint8)
        flat = lumas.view(count, rows * cols)
        for start in range(0, count, WRITE_FRAMES):
            part = torch.cat([flat[start:start + WRITE_FRAMES],
                              chroma[start:start + WRITE_FRAMES]], dim=1)
            clip.write(part.cpu().numpy().data)
        return lumas[self.sampled_ids].cpu()

    def _reset(self) -> None:
        self.passes: list[tuple[int, list[int], list[float]]] = []
        self.totals = dict.fromkeys(STATS, 0.0)

    def call(self) -> None:
        """One whole pass over the clip, as the command line makes it."""
        stats: dict = {}
        frames, results = detect_video(self.settings, engine=self.engine,
                                       out=self.sink, stats=stats)
        self.passes.append((frames, [frame for frame, _ in results],
                            [corr for _, corr in results]))
        for key in STATS:
            self.totals[key] += stats[key]

    def run(self, ctx) -> None:
        self._reset()
        if ctx.trace:
            traced(ctx, lambda: closed_loop(
                ctx, self.call, min(ctx.seconds, ctx.params["trace_seconds"])))
        else:
            closed_loop(ctx, self.call, ctx.seconds)
        for key, value in self.totals.items():
            ctx.counters[f"video.{key}"] = value
        ctx.counters["frames"] = self.totals["frames"]
        answered = self.answers()["answered"]
        ctx.attempted = answered.numel()
        ctx.failed = int((~answered).sum())
        ctx.extra["video"] = {"passes": len(self.passes),
                              "pump": ("native" if native_available()
                                       else "python")}

    def answers(self) -> dict:
        """Each pass's correlation of each sampled frame (NaN where none
        came) and whether it came; ``missing`` counts, over the passes,
        the sampled frames not returned once and in order, returned
        frames that are not sampled, and frames read other than the
        clip's."""
        where = {frame: i for i, frame in enumerate(self.sampled_ids)}
        shape = (len(self.passes), len(self.sampled_ids))
        corrs = torch.full(shape, math.nan, dtype=torch.float64)
        answered = torch.zeros(shape, dtype=torch.bool)
        missing = 0
        for row, (frames, ids, values) in enumerate(self.passes):
            if ids != self.sampled_ids or frames != self.clip_frames:
                missing += max(1, len(set(ids) ^ set(self.sampled_ids))
                               + abs(frames - self.clip_frames))
            for frame, value in zip(ids, values):
                if frame in where:
                    corrs[row, where[frame]] = value
                    answered[row, where[frame]] = True
        return {"corrs": corrs, "answered": answered, "missing": missing}

    def release(self) -> None:
        self.engine = None
        self.sink.close()
        self._remove()

    def expected(self, dtype: torch.dtype) -> dict:
        """The reference's correlation of each sampled luma, in ``dtype``,
        as one pass that answered every sampled frame."""
        lumas = self.sampled.to(self.watermark.device)
        corrs = plain.detect(lumas, self.watermark, self.p, dtype).cpu()
        return {"corrs": corrs.double()[None],
                "answered": torch.ones(1, len(self.sampled_ids),
                                       dtype=torch.bool),
                "missing": 0}

    @staticmethod
    def compare(got: dict, want: dict) -> dict:
        """The widest gap of any pass's correlation of a sampled frame from
        the reference's, and the frames that went missing."""
        gaps = (got["corrs"] - want["corrs"]).abs()[got["answered"]]
        return {"corr_abs": float(gaps.max()) if gaps.numel() else math.inf,
                "missing": got["missing"]}
