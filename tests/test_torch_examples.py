"""The port's examples (``examples/*_torch.py``) against the JAX package's
examples of the same names, on the CPU: each port example's ``main(...,
device="cpu")`` and the JAX example run by
``tools/chip_smoke_reference.py``'s runners (its engine or services
wrapped so that what it computes is recorded at full precision).

Sizes: the image and identification examples on a 96 x 128 PNG from a
numpy seed (written by the port's PNG writer) with a watermark of the same
size; the video and the serving examples at the JAX examples' own sizes
(640 x 360, 60 frames; 360 x 640, 32 frames).
Tolerances, the JAX suite's: correlations abs 2e-4 (identification 3e-4),
ME strengths rel 2e-3.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from watermarking_gpu_tpu_torch.io.images import read_png, write_png
from watermarking_gpu_tpu_torch.io.matfile import (generate_watermark,
                                                   save_watermark)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
CORR_ATOL, MANY_ATOL, STRENGTH_RTOL = 2e-4, 3e-4, 2e-3
EXAMPLES = ("image_watermark", "identify_watermark", "video_watermark",
            "serving_demo")


def load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


ref = load(REPO / "tools" / "chip_smoke_reference.py", "chip_smoke_reference")


def example(name: str):
    return load(REPO / "examples" / f"{name}_torch.py", f"{name}_torch")


@pytest.fixture()
def inputs(tmp_path):
    """A 96 x 128 RGB PNG and a watermark .dat of its size."""
    rng = np.random.default_rng(28390211)
    yy, xx = np.mgrid[0:96, 0:128].astype(np.float32)
    base = 110 + 60 * np.sin(xx / 6.0) * np.cos(yy / 5.0)
    png = tmp_path / "img.png"
    write_png(png, np.clip(base[..., None] + rng.normal(0, 12, (96, 128, 3)),
                           0, 255).astype(np.uint8))
    dat = tmp_path / "w.dat"
    save_watermark(dat, generate_watermark(96, 128, 28390211))
    return str(png), str(dat)


def test_image_example_matches_jax(inputs, tmp_path, capsys):
    png, dat = inputs
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    want = ref.run_jax_image_example(png, dat, str(tmp_path / "jax"))
    got = example("image_watermark").main(png, dat, device="cpu",
                                          out_dir=str(tmp_path / "port"))
    out = capsys.readouterr().out
    for mask in ("NVF", "ME"):
        assert abs(got[mask]["strength"] / want[mask]["strength"] - 1) <= (
            STRENGTH_RTOL)
        for key in ("corr_marked", "corr_clean"):
            assert abs(got[mask][key] - want[mask][key]) <= CORR_ATOL
        assert got[mask]["corr_marked"] > got[mask]["corr_clean"] + 0.05
        assert read_png(got[mask]["path"]).shape == (96, 128)
        assert (tmp_path / "jax" / f"marked_{mask.lower()}.png").is_file()
    assert [line.split(":")[0] for line in out.splitlines()] == [
        "NVF", "ME", "watermarked images written to " + str(tmp_path / "port")
        + "/marked_{nvf,me}.png"]


def test_identify_example_matches_jax(inputs, capsys):
    png, _ = inputs
    want = ref.run_jax_identify_example(png, 16)
    got = example("identify_watermark").main(png, 16, device="cpu")
    out = capsys.readouterr().out
    assert got["true_index"] == got["best"] == 8
    assert abs(got["strength"] / want["strength"] - 1) <= STRENGTH_RTOL
    np.testing.assert_allclose(got["corrs"], want["corrs"], rtol=0,
                               atol=MANY_ATOL)
    assert "candidate  8: " in out and out.rstrip().endswith("correct.")


def test_video_example_matches_jax(capsys):
    want = ref.run_jax_video_example()
    got = example("video_watermark").main(device="cpu")
    out = capsys.readouterr().out
    for name in ("marked", "clean"):
        assert [i for i, _ in got[name]] == list(range(0, 60, 10))
        np.testing.assert_allclose([c for _, c in got[name]], want[name],
                                   rtol=0, atol=CORR_ATOL)
    marked = min(c for _, c in got["marked"])
    clean = max(abs(c) for _, c in got["clean"])
    assert marked - clean >= min(want["marked"]) - max(
        abs(c) for c in want["clean"]) - 2 * CORR_ATOL
    assert "-- detection on the clean clip (should be ~0) --" in out


def test_serving_example_matches_jax(capsys):
    want = ref.run_jax_serving_example()
    got = example("serving_demo").main(device="cpu")
    out = capsys.readouterr().out
    np.testing.assert_allclose(got["corrs"], want["corrs"], rtol=0,
                               atol=CORR_ATOL)
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=0,
                               atol=MANY_ATOL)
    assert got["identified"] == int(np.argmax(want["scores"])) == 0
    assert "32 frames embed+detect in" in out
    assert "identified candidate 0" in out


@pytest.mark.parametrize("name", EXAMPLES)
def test_examples_need_the_card(name):
    """Without ``device`` an example runs on the card: with none it stops
    and names how to run elsewhere."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the example would run on it")
    with pytest.raises(SystemExit, match='device="cpu"'):
        example(name).main()
