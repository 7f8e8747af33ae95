"""The NVF configuration's pieces at sizes the CPU holds: the NVF reference
against the port's plain and kernel-plain routes and a hand-worked mask,
the step's operation count against a hand count, the kind's check
catching faults and the control, and its launch report."""

import json
import time
from pathlib import Path

import pytest
import torch

from watermarking_gpu_tpu_torch.models import batch_detect, batch_embed
from watermarking_gpu_tpu_torch.ops.nvf import nvf_mask as port_nvf_mask
from wmbench import harness, inputs
from wmbench.reference import plain, plain_nvf
from wmbench.traffic import step_loop_nvf
from wmbench.work import counts, kernels, peaks, step

ROOT = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
CELL = "nvf_p3_1080p.bulk_b8"
TINY = {"rows": 48, "cols": 64, "batch": 4, "ring": 2,
        "trace_seconds": 0.2}
CPU = torch.device("cpu")
SEED = 2 ** 31 + 29

torch.set_num_threads(2)


def context(seed=SEED, trace=False, overrides=TINY):
    return harness.Context(MANIFEST, CELL, seed, 0.2, trace, CPU,
                           overrides=overrides)


@pytest.mark.parametrize("impl", ["torch", "cuda"])
@pytest.mark.parametrize("shape", [(2, 48, 64), (3, 37, 53)])
def test_the_reference_agrees_with_the_ports_routes(shape, impl):
    """``impl="cuda"`` on CPU tensors runs the kernels' plain versions."""
    frames = inputs.frames(SEED, *shape, CPU)
    watermark = inputs.watermark(SEED, *shape[1:], CPU)
    sf = plain.strength_factor(40.0)
    marked, strength = batch_embed(frames, frames, watermark, sf, "nvf",
                                   p=3, impl=impl)
    ref_marked, ref_strength = plain_nvf.embed(frames, watermark, 40.0, 3)
    assert (marked.double() - ref_marked).abs().max() < 0.01
    assert ((strength.double() - ref_strength).abs()
            / ref_strength).max() < 1e-5
    corr = batch_detect(marked, watermark, "nvf", p=3, impl=impl)
    ref_corr = plain_nvf.detect(marked, watermark, 3)
    assert (corr.double() - ref_corr).abs().max() < 1e-4
    assert ref_corr.min() > 0.2
    unmarked = plain_nvf.detect(frames, watermark, 3)
    assert unmarked.abs().max() < 0.2


def test_the_mask_against_a_hand_worked_frame():
    """One bright corner pixel of 9: its clamped window holds it 4 times at
    the corner, twice beside it, once in the middle, never beyond."""
    frame = torch.zeros(3, 3, dtype=torch.float64)
    frame[0, 0] = 9.0
    want = torch.tensor([[20 / 21, 14 / 15, 0.0],
                         [14 / 15, 8 / 9, 0.0],
                         [0.0, 0.0, 0.0]], dtype=torch.float64)
    assert torch.allclose(plain_nvf.nvf_mask(frame, 3), want, rtol=0,
                          atol=1e-15)
    assert torch.allclose(port_nvf_mask(frame.float(), 3).double(), want,
                          rtol=0, atol=1e-6)


@pytest.mark.parametrize("p", [3, 5])
def test_a_flat_frame_has_no_mask_and_edges_clamp(p):
    flat = torch.full((7, 9), 117.0, dtype=torch.float64)
    assert torch.equal(plain_nvf.nvf_mask(flat, p), torch.zeros_like(flat))
    ramp = torch.arange(9, dtype=torch.float64).expand(7, 9).clone()
    mask = plain_nvf.nvf_mask(ramp, p)
    # clamped at the columns' ends, a window there repeats its edge column
    h = p // 2
    cols = [min(max(c, 0), 8) for c in range(-h, h + 1)]
    left = torch.tensor(cols, dtype=torch.float64)
    var = (left ** 2).mean() - left.mean() ** 2
    assert mask[3, 0] == pytest.approx(float(var / (1 + var)), abs=1e-15)
    assert torch.allclose(mask, port_nvf_mask(ramp.float(), p).double(),
                          atol=1e-6)
    assert torch.allclose(mask[0], mask[6])


def test_the_step_count_against_a_hand_count():
    """B = 2 frames of 10 x 12: 240 pixels. Bytes: frames 960, watermark
    480, marked frames 960, 8 a frame. Flops a pixel at p = 3: the Gram 26,
    the embed 15 + 7, the detect 32 + 15 + 7, 102; one 392-operation solve
    a frame. At p = 5 the mask takes 23: 118 a pixel."""
    config = {"mask": "nvf", "p": 3, "rows": 10, "cols": 12}
    assert counts("step_nvf", config, {"batch": 2}) == (2416, 102 * 240
                                                        + 2 * 392)
    assert counts("step_nvf", {**config, "p": 5}, {"batch": 2}) == (
        2416, 118 * 240 + 2 * 392)
    assert kernels.SOLVE_OPS == 392 and step.lags(3) == 13
    with pytest.raises(ValueError):
        counts("step_nvf", {**config, "mask": "me"}, {"batch": 2})


def test_the_1080p_step_is_bound_by_bytes_at_the_me_steps_time():
    nbytes, flops = counts("step_nvf", json.loads(
        (ROOT / "wmbench/configs/nvf_p3_1080p.json").read_text()),
        {"batch": 8})
    me = counts("step", {"mask": "me", "p": 3, "rows": 1080, "cols": 1920},
                {"batch": 8})
    assert nbytes == me[0] and flops < me[1]
    least, by = peaks.least_seconds(nbytes, flops, "NVIDIA H100 80GB HBM3")
    assert by == "bytes" and least * 1e3 == pytest.approx(0.04209, 1e-3)


def ran_cell():
    ctx = context()
    cell = harness.kind(ctx.params).Cell(ctx)
    cell.run(ctx)
    return ctx, cell


def test_the_check_catches_faults_and_the_control():
    ctx, cell = ran_cell()
    got = cell.answers()
    want = cell.expected(torch.float64)
    limits = ctx.params["limits"]
    assert harness.check_numbers(cell.compare(got, want), limits)[0]
    unmarked = {**got, "marked": [cell.frames[slot]
                                  for slot in range(cell.ring)]}
    off = {**got, "corrs": got["corrs"].clone()}
    off["corrs"].view(-1)[0] += 0.01
    control = cell.expected(torch.bfloat16)
    for name, bad in (("unmarked", unmarked), ("corr", off),
                      ("control", control)):
        correct, checks = harness.check_numbers(cell.compare(bad, want),
                                                limits)
        assert not correct, (name, checks)
    # the ME reference does not pass for the NVF answers either
    me_marked, _ = plain.embed(cell.frames.reshape(-1, 48, 64),
                               cell.watermark, cell.psnr, cell.p)
    assert (me_marked.view(cell.ring, cell.batch, 48, 64)[0].double()
            - got["marked"][0].double()).abs().max() > limits["pixel_abs"]


def test_a_run_reports_its_launches_and_no_metric_of_them():
    for trace in (False, True):
        result = harness.run(context(trace=trace), time.perf_counter())
        assert result["correct"], result["checks"]
        assert result["launches"]["counts"] == dict.fromkeys(
            ("embed_field", "embed_field.nvf", "embed_chain",
             "detect_partials", "detect_partials.nvf", "detect_chain"), 0)
        assert result["launches"]["shares"] == {}
        assert not any("launch" in name for name in result["metrics"])


def test_the_launch_report_takes_what_the_program_counts():
    before = {"embed_field": 3, "embed_field.nvf": 1, "embed_chain": 3,
              "detect_partials": 5, "detect_partials.nvf": 3,
              "detect_chain": 5}
    after = {"embed_field": 13, "embed_field.nvf": 11, "embed_chain": 13,
             "detect_partials": 15, "detect_partials.nvf": 13,
             "detect_chain": 10}
    report = step_loop_nvf.launch_report(before, after)
    assert report["shares"] == {"embed_field.nvf": 1.0, "embed_chain": 1.0,
                                "detect_partials.nvf": 1.0,
                                "detect_chain": 0.5}
    # a program without the NVF counters: the shares it can give
    older = {name: value for name, value in after.items()
             if not name.endswith(".nvf")}
    report = step_loop_nvf.launch_report(
        {name: before[name] for name in older}, older)
    assert set(report["shares"]) == {"embed_chain", "detect_chain"}
    assert set(step_loop_nvf.counts()) >= set(older)
