"""The video detection cell at sizes the CPU holds: a run through the
harness is correct and reads every metric; a correlation altered where it
is produced, half a batch left out or a sampled frame dropped makes it not
correct; the clip is drawn from the seed and deleted after the run."""

import gc
import math
import tempfile
import time
from pathlib import Path

import pytest
import torch

from watermarking_gpu_tpu_torch.models import BatchedWatermark
from watermarking_gpu_tpu_torch.video import pipeline
from wmbench import harness
from wmbench.tests.test_wmbench_reference import _altered, _half_method
from wmbench.traffic import video_loop

ROOT = Path(__file__).resolve().parents[2]
CELL = "me_p3_1080p.video_detect_i30"
ON_CELL = {"source": "program_counter", "layer": "video",
           "moves": "video_fps", "workloads": [CELL]}
# The cell's entries, to be appended to BENCHMARK.json's lists once its
# rate holds a bound (the bound here is a placeholder in the manifest's
# range, not a measured one); each is added here only where the file
# lacks it.
ENTRIES = {
    "workloads": [{
        "name": CELL, "config": "me_p3_1080p", "traffic": "video_detect_i30",
        "chips": 1,
        "why": "closed loop of whole video.detect_video passes over a seeded "
               "raw YUV420p 1080p clip, 480 frames (1.49 GB) in TMPDIR, "
               "interval 30, batch 8: frame pump, pinned staging, u8 upload, "
               "detect; no decode"}],
    "end_to_end": [{
        "name": "video_fps", "unit": "frames/s", "better": "higher",
        "bound": 0.25, "source": "host_clock", "workloads": [CELL]}],
    "per_layer": [{"name": f"video.{name}", "unit": "ms", "better": "lower",
                   **ON_CELL} for name in ("read_ms", "prep_ms", "collect_ms")],
}


def with_the_cell(manifest: dict) -> dict:
    for group, entries in ENTRIES.items():
        names = {entry["name"] for entry in manifest[group]}
        manifest[group] += [entry for entry in entries
                            if entry["name"] not in names]
    return manifest


MANIFEST = with_the_cell(harness.load_json(ROOT / "BENCHMARK.json"))
SMALL = {"rows": 48, "cols": 64, "clip_frames": 150, "trace_seconds": 0.2}
CPU = torch.device("cpu")

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def tmpdir_of_its_own(tmp_path, monkeypatch):
    """Each test's clips go to a directory of its own, which the test
    looks into."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    return tmp_path


def clips_in(directory):
    return sorted(directory.glob("wmbench-clip-*"))


def context(trace=False, seed=2 ** 31 + 21, **overrides):
    return harness.Context(MANIFEST, CELL, seed, 0.2, trace, CPU,
                           overrides={**SMALL, **overrides})


def metric_names(trace):
    group = MANIFEST["per_layer" if trace else "end_to_end"]
    return {metric["name"] for metric in group
            if CELL in metric.get("workloads", [CELL])}


@pytest.mark.parametrize("trace", [False, True])
def test_the_cell_runs_correct_and_reads_every_metric(trace,
                                                      tmpdir_of_its_own):
    result = harness.run(context(trace), time.perf_counter())
    assert result["correct"], result["checks"]
    assert result["failed"] == 0
    passes = result["video"]["passes"]
    assert passes >= 1 and result["attempted"] == 5 * passes
    assert set(result["metrics"]) == metric_names(trace)
    assert metric_names(trace) >= ({"video.read_ms", "video.prep_ms",
                                    "video.collect_ms"} if trace
                                   else {"video_fps", "setup_s"})
    for name, metric in result["metrics"].items():
        assert math.isfinite(metric["value"]) and metric["value"] >= 0, name
    assert clips_in(tmpdir_of_its_own) == []


def test_the_rate_counts_every_frame_of_every_pass():
    ctx = context()
    cell = harness.kind(ctx.params).Cell(ctx)
    cell.run(ctx)
    passes = ctx.extra["video"]["passes"]
    assert ctx.counters["frames"] == 150 * passes
    assert ctx.counters["video.batches"] == passes      # 5 sampled, batch 8
    seconds, calls = ctx.spans["window"]
    assert calls == passes
    assert harness.reader(ROOT / "wmbench", "video_fps")(ctx) == (
        150 * passes / seconds)
    cell.release()


def test_the_clip_is_the_seeds_and_half_its_samples_are_marked(
        tmpdir_of_its_own):
    clips, cells = [], []
    for seed in (2 ** 31 + 21, 2 ** 31 + 21, 2 ** 31 + 22):
        cell = harness.kind(context().params).Cell(context(seed=seed))
        clips.append(Path(cell.path).read_bytes())
        cells.append(cell)
    assert len(clips[0]) == 150 * 48 * 64 * 3 // 2
    assert clips[0] == clips[1] != clips[2]
    chroma = clips[0][48 * 64:48 * 64 * 3 // 2]
    assert len(set(chroma)) > 100
    corrs = cells[0].expected(torch.float64)["corrs"][0]
    assert (corrs[0::2] > 0.05).all() and (corrs[1::2].abs() < 0.05).all()
    for cell in cells:
        cell.release()
    assert clips_in(tmpdir_of_its_own) == []


def test_the_control_fails_the_corr_limit():
    ctx = context()
    cell = harness.kind(ctx.params).Cell(ctx)
    numbers = cell.compare(cell.expected(torch.bfloat16),
                           cell.expected(torch.float64))
    cell.release()
    assert numbers["corr_abs"] > ctx.params["limits"]["corr_abs"]
    assert numbers["missing"] == 0


@pytest.mark.parametrize("fault", ["altered", "half_batch"])
def test_a_broken_detection_is_not_correct(fault, monkeypatch):
    real = BatchedWatermark.detect
    wrap = _altered if fault == "altered" else _half_method
    monkeypatch.setattr(BatchedWatermark, "detect", wrap(real))
    result = harness.run(context(), time.perf_counter())
    assert not result["correct"], result["checks"]
    assert result["checks"]["corr_abs"]["value"] > 0.001
    assert result["checks"]["missing"]["value"] == 0


def test_a_dropped_sampled_frame_is_missing(monkeypatch):
    """Frame 30, a sampled one, is read and dropped in every pass: each
    pass reads a frame fewer, and every later sample is another frame."""
    real = pipeline.FrameSource.next

    def dropping(self):
        self.served = getattr(self, "served", 0) + 1
        if self.served == 31:
            real(self)
        return real(self)

    monkeypatch.setattr(pipeline.FrameSource, "next", dropping)
    result = harness.run(context(), time.perf_counter())
    assert not result["correct"], result["checks"]
    assert result["checks"]["missing"]["value"] >= 1


def test_an_unanswered_sample_counts_as_missing_and_failed(monkeypatch):
    real = video_loop.detect_video

    def short(*args, **kwargs):
        frames, results = real(*args, **kwargs)
        return frames, results[:-1]

    monkeypatch.setattr(video_loop, "detect_video", short)
    result = harness.run(context(), time.perf_counter())
    assert not result["correct"], result["checks"]
    assert result["failed"] == result["video"]["passes"]
    assert result["checks"]["missing"]["value"] == result["video"]["passes"]


def test_the_clip_is_deleted_when_the_run_fails(monkeypatch,
                                                tmpdir_of_its_own):
    def failing(*args, **kwargs):
        raise RuntimeError("a pass failed")

    monkeypatch.setattr(video_loop, "detect_video", failing)
    with pytest.raises(RuntimeError, match="a pass failed"):
        harness.run(context(), time.perf_counter())
    gc.collect()
    assert clips_in(tmpdir_of_its_own) == []


def test_too_little_room_in_tmpdir_is_a_clear_error(monkeypatch,
                                                    tmpdir_of_its_own):
    monkeypatch.setattr(video_loop.shutil, "disk_usage",
                        lambda path: type("Usage", (), {"free": 1000})())
    with pytest.raises(RuntimeError, match="needs twice"):
        harness.kind(context().params).Cell(context())
    assert clips_in(tmpdir_of_its_own) == []


def test_the_cells_entries_keep_to_the_manifests_rules(monkeypatch):
    from wmbench.tests import test_wmbench_manifest as rules
    monkeypatch.setattr(rules, "MANIFEST", MANIFEST)
    rules.test_names_units_and_text()
    rules.test_metrics_have_readers_bounds_and_layers()
    rules.test_each_cell_has_its_files_and_metrics(ENTRIES["workloads"][0])
