"""The port's tools (``watermarking_gpu_tpu_torch/tools/``) against the JAX
package's ``tools/`` scripts, on the CPU: the same arguments and inputs
through both, the port's ``main(argv, device="cpu", results=...)``, the JAX
tool's ``main()`` run by ``tools/chip_smoke_reference.py``'s runners (its
engine wrapped so that what it computes is recorded at full precision).

Inputs: a 96 x 128 PNG from a numpy seed, written by the port's PNG writer.
Tolerances, the JAX suite's: ``.dat`` files byte-equal, correlations abs
2e-4 (detect) and 3e-4 (identification: the null matrix and the
statistics taken from it), ME strengths rel 2e-3, the threshold (mean +
z * std) within (1 + z) * 3e-4.
"""

import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from watermarking_gpu_tpu_torch import Watermark
from watermarking_gpu_tpu_torch.io.images import write_png
from watermarking_gpu_tpu_torch.tools import (calibrate_threshold,
                                              evaluate_robustness,
                                              generate_watermark)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
CORR_ATOL, MANY_ATOL, STRENGTH_RTOL = 2e-4, 3e-4, 2e-3


def load_reference():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_reference", REPO / "tools" / "chip_smoke_reference.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


ref = load_reference()


@pytest.fixture()
def png(tmp_path):
    rng = np.random.default_rng(28390211)
    yy, xx = np.mgrid[0:96, 0:128].astype(np.float32)
    base = 110 + 60 * np.sin(xx / 6.0) * np.cos(yy / 5.0)
    image = np.clip(base[..., None] + rng.normal(0, 12, (96, 128, 3)), 0,
                    255).astype(np.uint8)
    path = tmp_path / "img.png"
    write_png(path, image)
    return str(path)


@pytest.mark.parametrize("rows, cols", [(64, 64), (37, 83)])
@pytest.mark.parametrize("repeat", [None, 3])
def test_generate_watermark_matches_jax(tmp_path, capsys, rows, cols,
                                        repeat):
    jax_tool = ref.load_script("tools/generate_watermark.py")
    extra = [] if repeat is None else ["--repeat-blocks", str(repeat)]
    outs = {}
    for name, main in (("jax", jax_tool.main),
                       ("port", generate_watermark.main)):
        path = tmp_path / f"{name}.dat"
        assert main([str(rows), str(cols), "28390211", str(path),
                     *extra]) == 0
        outs[name] = (path.read_bytes(),
                      capsys.readouterr().out.replace(str(path), "PATH"))
    assert outs["port"] == outs["jax"]
    assert len(outs["port"][0]) == 4 * rows * cols


def test_generate_watermark_error_matches_jax(tmp_path, capsys):
    jax_tool = ref.load_script("tools/generate_watermark.py")
    argv = ["0", "64", "1", str(tmp_path / "w.dat")]
    assert jax_tool.main(argv) == 1
    jax_err = capsys.readouterr().err
    assert generate_watermark.main(argv) == 1
    assert capsys.readouterr().err == jax_err
    assert "less than 32768" in jax_err and not (tmp_path / "w.dat").exists()


@pytest.mark.parametrize("extra", [[], ["--mask", "nvf"], ["--p", "5"]],
                         ids=["me3", "nvf3", "me5"])
def test_calibrate_threshold_matches_jax(png, capsys, extra):
    argv = [png, "--images", "4", "--nulls", "32", *extra]
    want = ref.run_jax_calibrate(argv)
    got = {}
    rc = calibrate_threshold.main(argv, device="cpu", results=got)
    out = capsys.readouterr().out
    assert rc == want["rc"]
    assert got["nulls"].shape == want["nulls"].shape == (4, 32)
    np.testing.assert_allclose(got["nulls"], want["nulls"], rtol=0,
                               atol=MANY_ATOL)
    np.testing.assert_allclose(got["signals"], want["signals"], rtol=0,
                               atol=CORR_ATOL)
    for key in ("mean", "std_min", "std_max", "max", "signal_mean",
                "signal_min"):
        assert abs(got[key] - want[key]) <= MANY_ATOL, key
    assert got["z"] == want["z"]
    assert abs(got["threshold"] - want["threshold"]) <= (
        (1 + want["z"]) * MANY_ATOL)
    assert got["misses"] == int((want["signals"] <= want["threshold"]).sum())
    # the JAX tool's five lines, then the port's timing line
    lines, jax_lines = out.splitlines(), want["out"].splitlines()
    assert len(lines) == len(jax_lines) + 1 and lines[0] == jax_lines[0]
    assert [line.split(":")[0] for line in lines[1:-1]] == [
        line.split(":")[0] for line in jax_lines[1:]]
    assert lines[-1].startswith("time: 36 matrices generated on the host")


@pytest.mark.parametrize("mask", ["me", "nvf"])
def test_evaluate_robustness_matches_jax(png, capsys, mask):
    argv = [png, "--mask", mask, "--psnr", "35"]
    want = ref.run_jax_robustness(argv)
    got = {}
    assert evaluate_robustness.main(argv, device="cpu", results=got) == 0
    out = capsys.readouterr().out
    assert want["rc"] == 0
    assert abs(got["strength"] / want["strength"] - 1) <= STRENGTH_RTOL
    assert [name for name, _ in got["rows"]] == list(want["rows"])
    for name, corr in got["rows"]:
        if not name.startswith("jpeg"):   # see the test below
            assert abs(corr - want["rows"][name]) <= CORR_ATOL, name
    assert got["batch"] == 13
    rows = dict(got["rows"])
    assert rows["none"] > rows["clean image (no mark)"] + 0.1
    # the same lines, up to the last digit of a number
    def labels(text):
        return [line.split("  ")[0].split(", strength=")[0]
                for line in text.splitlines()]
    assert labels(out) == labels(want["out"])


@pytest.mark.parametrize("mask", ["me", "nvf"])
def test_jpeg_rows_match_jax_on_the_same_frame(png, mask):
    """The JPEG attack encodes the u8 truncation of the marked frame, so a
    pixel whose two marks (within the suite's 1e-2) straddle an integer
    changes a whole 8 x 8 block: the JPEG rows are held to the JAX tool's
    attack and detector on the port's own marked frame, and the two marks'
    truncations may differ only at such pixels."""
    argv = [png, "--mask", mask, "--psnr", "35"]
    got = {}
    assert evaluate_robustness.main(argv, device="cpu", results=got) == 0
    jax_tool = ref.load_script("tools/evaluate_robustness.py")
    marked = np.clip(got["marked"], 0, 255)
    frames = [jax_tool.jpeg_roundtrip(marked, q)
              for q in evaluate_robustness.JPEG_QUALITIES]
    for q, frame in zip(evaluate_robustness.JPEG_QUALITIES, frames):
        assert np.array_equal(frame,
                              evaluate_robustness.jpeg_roundtrip(marked, q))
    gray = jax_tool.load_image_gray(png)
    rows, cols = gray.shape
    engine = jax_tool.BatchedWatermark(
        rows, cols, jax_tool.generate_watermark(rows, cols, 28390211), p=3,
        psnr=35.0)
    want = np.asarray(engine.detect(np.stack(frames), mask))
    jpeg_rows = [corr for name, corr in got["rows"] if name.startswith("jpeg")]
    np.testing.assert_allclose(jpeg_rows, want, rtol=0, atol=CORR_ATOL)
    jax_marked = np.asarray(engine.embed(gray[None], mask_type=mask)[0])[0]
    flips = marked.astype(np.uint8) != np.clip(jax_marked, 0,
                                               255).astype(np.uint8)
    assert np.abs(got["marked"] - jax_marked).max() <= 1e-2
    assert np.all(np.floor(got["marked"][flips])
                  != np.floor(jax_marked[flips]))


def test_evaluate_robustness_without_pillow(png, capsys, monkeypatch):
    """Without Pillow the JPEG rows print as skipped, the batch holds the
    nine other attacks, and their correlations are the 13-frame batch's."""
    argv = [png, "--psnr", "35"]
    with_pillow = {}
    assert evaluate_robustness.main(argv, device="cpu",
                                    results=with_pillow) == 0
    capsys.readouterr()
    monkeypatch.setitem(sys.modules, "PIL", None)
    without = {}
    assert evaluate_robustness.main(argv, device="cpu", results=without) == 0
    out = capsys.readouterr().out
    assert without["batch"] == 9 and with_pillow["batch"] == 13
    assert without["strength"] == with_pillow["strength"]
    skipped = [line for line in out.splitlines() if line.startswith("jpeg")]
    assert [line.split()[1] for line in skipped] == [
        f"q={q}" for q in evaluate_robustness.JPEG_QUALITIES]
    assert all(line.endswith(evaluate_robustness.JPEG_SKIPPED)
               for line in skipped)
    pillow_rows = dict(with_pillow["rows"])
    for name, corr in without["rows"]:
        if name.startswith("jpeg"):
            assert corr is None
        else:
            assert abs(corr - pillow_rows[name]) <= CORR_ATOL, name


@pytest.mark.parametrize("tool", [calibrate_threshold, evaluate_robustness],
                         ids=["calibrate", "robustness"])
def test_missing_image_exits_1_naming_it(tmp_path, capsys, tool):
    missing = str(tmp_path / "absent.png")
    assert tool.main([missing], device="cpu") == 1
    assert missing in capsys.readouterr().err


@pytest.mark.parametrize("tool", [calibrate_threshold, evaluate_robustness],
                         ids=["calibrate", "robustness"])
def test_tools_need_the_card(png, capsys, tool):
    """Without ``device`` the tools run on the card: with none they print
    the command line's message and exit 1, with no CPU fallback."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the tool would run on it")
    assert tool.main([png]) == 1
    out = capsys.readouterr().out
    assert "CUDA is not available" in out and "correlation" not in out


def test_reinitialize_embeds_and_detects_with_the_new_matrix():
    """calibrate_threshold re-points one engine at each signal's matrix:
    embed and detect after ``reinitialize`` equal a fresh engine's."""
    rng = np.random.default_rng(5)
    image = np.clip(rng.normal(128, 40, (48, 64)), 0, 255).astype(np.float32)
    first, second = (rng.normal(size=(48, 64)).astype(np.float32)
                     for _ in range(2))
    engine = Watermark(48, 64, first, device="cpu")
    marked_first, _ = engine.embed(image)
    engine.reinitialize(second, 48, 64)
    fresh = Watermark(48, 64, second, device="cpu")
    marked, strength = engine.embed(image)
    want, want_strength = fresh.embed(image)
    assert torch.equal(marked, want) and torch.equal(strength, want_strength)
    assert float(engine.detect(marked)) == float(fresh.detect(marked))
    assert float(engine.detect(marked)) > 0.05
    assert abs(float(engine.detect(marked_first))) < 0.05
