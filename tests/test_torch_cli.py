"""The port's settings.ini CLI (``cli/main.py``) against the JAX package's, on
the CPU: the same cases as tests/test_cli.py, with the port run through
``main(argv, device="cpu")``, and the command line's refusal to run
without a card.

Inputs: a 96 x 128 RGB PNG and a watermark from a numpy seed. Tolerances,
the JAX suite's: correlations abs 2e-4, strengths rel 2e-3 (ME strengths
carry the f32 Gram's reduction order through cond(Rx)).
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from watermarking_gpu_tpu.cli import main as jax_cli
from watermarking_gpu_tpu_torch.cli import main as cli
from watermarking_gpu_tpu_torch.io.images import read_png, write_png
from watermarking_gpu_tpu_torch.io.matfile import save_watermark
from watermarking_gpu_tpu_torch.video import synthesize

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
CORR_ATOL, STRENGTH_RTOL = 2e-4, 2e-3


@pytest.fixture()
def ini(tmp_path):
    """A settings.ini over a 96 x 128 RGB PNG and a watermark."""
    rng = np.random.default_rng(28390211)
    img_path = tmp_path / "img.png"
    write_png(img_path, np.clip(rng.normal(128, 40, (96, 128, 3)), 0,
                                255).astype(np.uint8))
    wm_path = tmp_path / "w.dat"
    save_watermark(wm_path, rng.normal(size=(96, 128)).astype(np.float32))
    path = tmp_path / "settings.ini"
    path.write_text(f"""
[paths]
image = {img_path}
watermark = {wm_path}

[options]
opencl_device = 0
save_watermarked_files_to_disk = true
execution_time_in_fps = false

[parameters]
p = 3
psnr = 40.0
loops_for_test = 1
""")
    return path, img_path


def edited(path: Path, old: str, new: str, name: str) -> str:
    out = path.parent / name
    out.write_text(path.read_text().replace(old, new))
    return str(out)


def run(main, argv, capsys, **kw) -> tuple[int, str]:
    rc = main(argv, **kw)
    return rc, capsys.readouterr().out


def results(out: str) -> dict[str, float]:
    """The strengths (NVF, then ME) and correlations the CLI printed."""
    strengths = re.findall(r"Watermark strength \(parameter a\): (\S+)", out)
    return {"strength_nvf": float(strengths[0]),
            "strength_me": float(strengths[1]),
            "corr_nvf": float(re.search(r"Correlation \[NVF\]: (\S+)",
                                        out).group(1)),
            "corr_me": float(re.search(r"Correlation \[ME\]: (\S+)",
                                       out).group(1))}


@pytest.mark.parametrize("p", [3, 5])
def test_cli_image_flow_matches_jax(ini, capsys, p):
    """Strengths, correlations and saved u8 images of the port's CLI
    against the JAX CLI's on the same PNG and watermark; at p=5 both print
    the generalized-predictor NOTE."""
    path, img_path = ini
    path = edited(path, "p = 3", f"p = {p}", f"p{p}.ini")
    rc, want_out = run(jax_cli.main, [path], capsys)
    assert rc == 0
    root, ext = os.path.splitext(img_path)
    saved = {s: read_png(f"{root}{s}{ext}") for s in ("_W_NVF", "_W_ME")}
    rc, out = run(cli.main, [path], capsys, device="cpu")
    assert rc == 0, out
    got, want = results(out), results(want_out)
    for key in ("corr_nvf", "corr_me"):
        assert abs(got[key] - want[key]) <= CORR_ATOL, (key, got, want)
        assert got[key] > 0.02
    for key in ("strength_nvf", "strength_me"):
        assert got[key] == pytest.approx(want[key], rel=STRENGTH_RTOL), key
    assert re.search(r"Correlation \[ME\]: \d\.\d{16}$", out, re.M)
    note = f"generalized {p * p - 1}-tap predictor"
    assert (note in out) == (note in want_out) == (p != 3)
    assert "Successfully saved to disk" in out
    for suffix, jax_image in saved.items():
        image = read_png(f"{root}{suffix}{ext}")
        assert image.shape == jax_image.shape == (96, 128, 3)
        delta = np.abs(image.astype(int) - jax_image.astype(int))
        assert delta.max() <= 1 and (delta > 0).mean() <= 1e-3, suffix


def test_cli_invalid_device_falls_back(monkeypatch, capsys):
    """opencl_device beyond the card count falls back to cuda:0 with the
    reference's NOTE (af::setDevice fallback, main.cpp:72-78)."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda index=0: f"Card {index}")
    assert cli._select_device(99) == torch.device("cuda", 0)
    out = capsys.readouterr().out
    assert "NOTE: Invalid device specified, using default 0" in out
    assert "Using device [0]: Card 0 (cuda)" in out
    assert cli._select_device(0) == torch.device("cuda", 0)
    assert "NOTE" not in capsys.readouterr().out


def test_main_without_a_card_refuses(ini, capsys, monkeypatch):
    """Without CUDA and without a device from the caller, main prints the
    error, returns 1 and runs nothing on the CPU."""
    path, img_path = ini
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def refuse(*args, **kwargs):
        raise AssertionError("the CLI ran without a card")
    monkeypatch.setattr(cli, "test_for_image", refuse)
    monkeypatch.setattr(cli, "Watermark", refuse)
    rc, out = run(cli.main, [str(path)], capsys)
    assert rc == 1
    assert "CUDA is not available" in out and "Correlation" not in out
    root, ext = os.path.splitext(img_path)
    assert not os.path.exists(f"{root}_W_ME{ext}")


def test_python_m_runs_the_cli(ini):
    """``python -m watermarking_gpu_tpu_torch <ini>`` is the command line;
    on a machine without a card it exits 1 before any work."""
    path, _ = ini
    result = subprocess.run(
        [sys.executable, "-m", "watermarking_gpu_tpu_torch", str(path)],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert result.returncode == 1, result.stdout + result.stderr
    assert "CUDA is not available" in result.stdout


def test_cli_missing_settings(capsys):
    rc, out = run(cli.main, ["/nonexistent/settings.ini"], capsys,
                  device="cpu")
    assert rc == 1 and "Could not load" in out


@pytest.mark.parametrize("old,new,message", [
    ("p = 3", "p = 4", "p parameter must be one of 3, 5, 7, 9"),
    ("psnr = 40.0", "psnr = -1", "PSNR must be a positive number")])
def test_cli_bad_parameters(ini, capsys, old, new, message):
    path, _ = ini
    for main in (jax_cli.main, cli.main):
        kw = {} if main is jax_cli.main else {"device": "cpu"}
        rc, out = run(main, [edited(path, old, new, "bad.ini")], capsys,
                      **kw)
        assert rc == 1 and message in out


def test_cli_small_image(tmp_path, ini, capsys):
    """Images below 64 px a side are rejected (main.cpp:161)."""
    path, img_path = ini
    small = tmp_path / "small.png"
    write_png(small, np.zeros((32, 32, 3), np.uint8))
    rc, out = run(cli.main, [edited(path, str(img_path), str(small),
                                    "small.ini")], capsys, device="cpu")
    assert rc == 1 and "Image dimensions too low" in out


def test_cli_wide_image_runs(tmp_path, capsys):
    """The JAX CLI's VMEM width guard is gone: a 64 x 4200 image runs."""
    rng = np.random.default_rng(5)
    img = tmp_path / "wide.png"
    write_png(img, np.clip(rng.normal(128, 40, (64, 4200)), 0,
                           255).astype(np.uint8))
    save_watermark(tmp_path / "w.dat",
                   rng.normal(size=(64, 4200)).astype(np.float32))
    path = tmp_path / "wide.ini"
    path.write_text(f"[paths]\nimage = {img}\nwatermark = {tmp_path}/w.dat\n"
                    "[parameters]\np = 3\npsnr = 40\nloops_for_test = 1\n")
    rc, out = run(cli.main, [str(path)], capsys, device="cpu")
    assert rc == 0, out
    assert float(re.search(r"Correlation \[ME\]: (\S+)", out).group(1)) > 0.02


def test_compilation_cache_dir_note(tmp_path, ini, capsys):
    """compilation_cache_dir parses and is answered with one NOTE: the
    port has no executable cache to enable."""
    path, _ = ini
    cached = edited(path, "[options]",
                    f"[options]\ncompilation_cache_dir = {tmp_path}/cache",
                    "cache.ini")
    rc, out = run(cli.main, [cached], capsys, device="cpu")
    assert rc == 0
    notes = [line for line in out.splitlines() if "compilation_cache_dir"
             in line]
    assert len(notes) == 1 and notes[0].startswith("NOTE:")
    assert not (tmp_path / "cache").exists()


@pytest.mark.parametrize("p", [3, 5])
def test_cli_video_dispatch_matches_jax(tmp_path, capsys, p):
    """[paths] video selects the video pipeline (detect mode); the
    correlations printed per sampled frame match the JAX CLI's."""
    rng = np.random.default_rng(9)
    clip = tmp_path / "clip.yuv"
    clip.write_bytes(synthesize(128, 96, 4, seed=1))
    wm = tmp_path / "w.dat"
    save_watermark(wm, rng.normal(size=(96, 128)).astype(np.float32))
    ini = tmp_path / "v.ini"
    ini.write_text(f"""
[paths]
video = {clip}
watermark = {wm}

[parameters]
p = {p}
psnr = 40.0

[parameters_video]
watermark_interval = 2
watermark_detection = true
raw_video_size = 128x96
""")
    pattern = r"Correlation for frame: (\d+): (\S+)"
    rc, want = run(jax_cli.main, [str(ini)], capsys)
    assert rc == 0
    rc, out = run(cli.main, [str(ini)], capsys, device="cpu")
    assert rc == 0, out
    got = re.findall(pattern, out)
    assert [frame for frame, _ in got] == ["0", "2"]
    assert "Watermark detection total execution time" in out
    for (frame, value), (want_frame, want_value) in zip(
            got, re.findall(pattern, want)):
        assert frame == want_frame
        assert abs(float(value) - float(want_value)) <= CORR_ATOL


def test_display_array(tmp_path):
    from watermarking_gpu_tpu_torch.utils import display_array
    arr = np.random.default_rng(4).normal(size=(32, 48))
    path = display_array(torch.from_numpy(arr), path=str(tmp_path / "d.png"))
    image = read_png(path)
    assert image.shape == (32, 48)
    assert image.min() == 0 and image.max() >= 254   # scaled to 0..255
    unit = display_array(np.full((4, 4), 0.5), path=str(tmp_path / "u.png"))
    assert (read_png(unit) == 127).all()


def test_profiling_trace(tmp_path):
    """trace() writes a Chrome trace holding the annotated span; None is
    a no-op."""
    from watermarking_gpu_tpu_torch.utils import annotate, trace
    log_dir = tmp_path / "trace"
    with trace(str(log_dir)):
        with annotate("embed-section"):
            torch.square(torch.arange(8.0))
    traces = list(log_dir.glob("trace_*.json"))
    assert len(traces) == 1 and "embed-section" in traces[0].read_text()
    with trace(None):
        pass
