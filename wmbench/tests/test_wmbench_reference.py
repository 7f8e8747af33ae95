"""The plain reference against the port's plain route, the control (the
reference in bfloat16) failing every cell's limits, and a run with the
timed path broken underneath coming out not correct, at sizes the CPU
holds."""

import json
import time
from pathlib import Path

import pytest
import torch

from watermarking_gpu_tpu_torch.models import BatchedWatermark
from watermarking_gpu_tpu_torch.ops.pipelines import (detect_many_pipeline,
                                                      detect_pipeline,
                                                      embed_pipeline)
from wmbench import harness, inputs
from wmbench.reference import plain
from wmbench.traffic import step_loop

ROOT = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [cell["name"] for cell in MANIFEST["workloads"]]
BULK = [name for name in CELLS if name.endswith("bulk_b8")]
TINY = {"rows": 48, "cols": 64, "batch": 4, "ring": 2, "pool": 6,
        "candidates": 5, "marked_frames": 2, "rate_per_s": 200,
        "trace_seconds": 0.2}
CPU = torch.device("cpu")

torch.set_num_threads(2)


def context(name, seed=2 ** 31 + 11):
    return harness.Context(MANIFEST, name, seed, 0.2, False, CPU,
                           overrides=TINY)


@pytest.mark.parametrize("p", [3, 9])
def test_reference_agrees_with_the_ports_plain_route(p):
    frames = inputs.frames(7, 3, 40, 56, CPU)
    watermark = inputs.watermark(7, 40, 56, CPU)
    bank = inputs.bank(7, 4, 40, 56, CPU)
    marked, strength = embed_pipeline(frames, frames, watermark,
                                      plain.strength_factor(40.0), "me",
                                      p=p, impl="torch")
    ref_marked, ref_strength = plain.embed(frames, watermark, 40.0, p)
    assert (marked.double() - ref_marked).abs().max() < 0.05
    assert ((strength.double() - ref_strength).abs()
            / ref_strength).max() < 1e-3
    corr = detect_pipeline(marked, watermark, "me", p=p, impl="torch")
    ref_corr = plain.detect(marked, watermark, p)
    assert (corr.double() - ref_corr).abs().max() < 1e-4
    assert ref_corr.min() > 0.05
    many = detect_many_pipeline(marked, bank, "me", p=p, impl="torch")
    ref_many = plain.detect_many(marked, bank, p, block=3)
    assert (many.double() - ref_many).abs().max() < 1e-4


@pytest.mark.parametrize("name", CELLS)
def test_the_program_passes_and_the_control_fails(name):
    ctx = context(name)
    result = harness.run(ctx, time.perf_counter())
    assert result["correct"], result["checks"]
    cell = harness.kind(ctx.params).Cell(context(name))
    want = cell.expected(torch.float64)
    numbers = cell.compare(cell.expected(torch.bfloat16), want)
    correct, checks = harness.check_numbers(numbers, ctx.params["limits"])
    assert not correct, checks
    cell.release()


@pytest.mark.parametrize("name", ["me_p3_1080p.identify_n64",
                                  "me_p3_1080p.serve_detect_u8"])
def test_the_set_up_leaves_out_the_reference_and_gc_and_host_reported(name):
    """The reference's marking of inputs is timed apart and left out of
    setup_s; the collector's pauses and the host's state come beside the
    metrics."""
    result = harness.run(context(name), time.perf_counter())
    phases = result["setup_phases_s"]
    assert phases["reference"] > 0
    assert result["metrics"]["setup_s"]["value"] == pytest.approx(
        phases["start"] + phases["inputs"] + phases["program"])
    assert set(result["gc"]) == {"collections", "pause_ms", "longest_ms"}
    assert len(result["host_probe_ms"]) == 2
    assert min(result["host_probe_ms"]) > 0


def test_the_bulk_check_keeps_a_sample_of_steps_drawn_from_the_seed():
    kept = []
    for seed in (2 ** 31 + 11, 2 ** 31 + 11, 2 ** 31 + 12):
        cell = harness.kind(context(BULK[0], seed).params).Cell(
            context(BULK[0], seed))
        for _ in range(96):
            cell.step()
        assert set(cell.last) == {0, 1}
        kept.append(len(cell.slots))
        assert 1 <= kept[-1] < 48
        cell.release()
    assert kept[0] == kept[1]


REAL_EMBED = step_loop.batch_embed
REAL_DETECT = step_loop.batch_detect


def _half(fn):
    """The second half of the batch left out: its answers are the mean of
    the first half's."""
    def broken(images, *args, **kwargs):
        half = images.shape[0] // 2
        out = fn(images[:half], *args, **kwargs)
        return torch.cat([out, out.mean(dim=0, keepdim=True).expand(
            images.shape[0] - half, *out.shape[1:])])
    return broken


def _half_method(fn):
    def broken(self, images, *args, **kwargs):
        return _half(lambda part: fn(self, part, *args, **kwargs))(images)
    return broken


def _altered(fn):
    """One answer altered where it is produced."""
    def broken(*args, **kwargs):
        out = fn(*args, **kwargs).clone()
        out.view(-1)[0] += 0.01
        return out
    return broken


def _unchanged(images, outputs, *args, **kwargs):
    """A step that returns its state unchanged: the frames come back as
    they went in."""
    return outputs.clone(), torch.ones(images.shape[:1])


def _half_embed(images, outputs, *args, **kwargs):
    half = images.shape[0] // 2
    marked, strength = REAL_EMBED(images[:half], outputs[:half], *args,
                                  **kwargs)
    return (torch.cat([marked, outputs[half:]]),
            torch.cat([strength, strength.mean().expand(
                images.shape[0] - half)]))


FAULTS = {
    "unchanged": {"batch_embed": _unchanged},
    "half_batch": {"batch_embed": _half_embed,
                   "batch_detect": _half(REAL_DETECT)},
    "altered": {"batch_detect": _altered(REAL_DETECT)},
}


@pytest.mark.parametrize("name", BULK)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_step_is_not_correct(name, fault, monkeypatch):
    for attr, broken in FAULTS[fault].items():
        monkeypatch.setattr(step_loop, attr, broken)
    result = harness.run(context(name), time.perf_counter())
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("fault", ["half_batch", "altered"])
def test_a_broken_identification_is_not_correct(fault, monkeypatch):
    real = BatchedWatermark.detect_many
    wrap = _altered if fault == "altered" else _half_method
    monkeypatch.setattr(BatchedWatermark, "detect_many", wrap(real))
    result = harness.run(context("me_p3_1080p.identify_n64"),
                         time.perf_counter())
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("fault", ["half_batch", "altered"])
def test_a_broken_service_is_not_correct(fault, monkeypatch):
    real = BatchedWatermark.detect
    wrap = _altered if fault == "altered" else _half_method
    monkeypatch.setattr(BatchedWatermark, "detect", wrap(real))
    result = harness.run(context("me_p3_1080p.serve_detect_u8"),
                         time.perf_counter())
    assert not result["correct"], result["checks"]
