"""The port stands alone: it imports neither JAX nor the JAX package, its
kernel build refuses to run without nvcc instead of falling back, its
wrappers launch nothing on CPU tensors, its engines run on the card unless
asked for the CPU, and window sizes other than 3, 5, 7, 9 raise."""

import inspect
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from watermarking_gpu_tpu_torch import BatchedWatermark, Watermark
from watermarking_gpu_tpu_torch.ops import cuda as kernels
from watermarking_gpu_tpu_torch.ops import pipelines
from watermarking_gpu_tpu_torch.ops.cuda import build

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
PACKAGE = REPO / "watermarking_gpu_tpu_torch"


def test_import_loads_no_jax():
    """Nor Pillow, which the card's machine does not have."""
    code = ("import sys; import watermarking_gpu_tpu_torch as p; "
            "import watermarking_gpu_tpu_torch.ops.cuda, "
            "watermarking_gpu_tpu_torch.utils, "
            "watermarking_gpu_tpu_torch.serving, "
            "watermarking_gpu_tpu_torch.parallel, "
            "watermarking_gpu_tpu_torch.cli.main, "
            "watermarking_gpu_tpu_torch.io, "
            "watermarking_gpu_tpu_torch.video, "
            "watermarking_gpu_tpu_torch.utils.profiling, "
            "watermarking_gpu_tpu_torch.tools.generate_watermark, "
            "watermarking_gpu_tpu_torch.tools.calibrate_threshold, "
            "watermarking_gpu_tpu_torch.tools.evaluate_robustness, "
            "watermarking_gpu_tpu_torch.__main__; "
            "bad = sorted(m for m in sys.modules if m.startswith('jax') or "
            "m.split('.')[0] in ('watermarking_gpu_tpu', 'PIL')); "
            "print(bad); sys.exit(1 if bad else 0)")
    result = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                            capture_output=True, text=True, timeout=120)
    assert result.returncode == 0, result.stdout + result.stderr


PORT_EXAMPLES = ("multichip_watermark", "image_watermark",
                 "identify_watermark", "video_watermark", "serving_demo")


def test_sources_name_no_jax():
    """Nor import Pillow, but in one place: ``jpeg_roundtrip`` of the
    robustness tool, inside the function (the JPEG attack is Pillow's
    codec; without it the tool skips those rows). chip_smoke.py and the
    port's examples import none of the three."""
    pattern = re.compile(r"^\s*(import|from)\s+(jax|PIL)\b"
                         r"|watermarking_gpu_tpu\b")
    sources = [path for suffix in ("*.py", "*.cu", "*.cuh")
               for path in PACKAGE.rglob(suffix)]
    offenders = [f"{path.relative_to(PACKAGE)}:{n}" for path in sources
                 for n, line in enumerate(path.read_text().splitlines(), 1)
                 if pattern.search(line)]
    assert len(sources) > 10
    robustness = PACKAGE / "tools" / "evaluate_robustness.py"
    lazy = [n for n, line in enumerate(robustness.read_text().splitlines(),
                                       1)
            if line == "    from PIL import Image"]
    assert len(lazy) == 1
    assert offenders == [f"tools/evaluate_robustness.py:{lazy[0]}"]
    imports = re.compile(r"^\s*(import|from)\s+(jax|PIL|watermarking_gpu_tpu)"
                         r"\b")
    scripts = ["chip_smoke.py", *(f"examples/{name}_torch.py"
                                  for name in PORT_EXAMPLES)]
    for script in scripts:
        lines = (REPO / script).read_text().splitlines()
        assert [line for line in lines if imports.search(line)] == [], script


@pytest.mark.parametrize("name", PORT_EXAMPLES[1:])
def test_example_loads_no_jax(name):
    """Each of the port's examples imports the port alone (nor Pillow), and
    runs on the card unless given another device."""
    code = ("import runpy, sys, inspect; "
            f"ns = runpy.run_path('examples/{name}_torch.py'); "
            "assert inspect.signature(ns['main']).parameters['device']"
            ".default is None; "
            "bad = sorted(m for m in sys.modules if m.startswith('jax') or "
            "m.split('.')[0] in ('watermarking_gpu_tpu', 'PIL')); "
            "print(bad); sys.exit(1 if bad else 0)")
    result = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                            capture_output=True, text=True, timeout=120)
    assert result.returncode == 0, result.stdout + result.stderr


def test_multichip_example_loads_no_jax():
    """The port's mesh example imports the port alone (nor Pillow), and
    runs on the card unless given other devices."""
    code = ("import runpy, sys; "
            "ns = runpy.run_path('examples/multichip_watermark_torch.py'); "
            "import inspect; "
            "assert inspect.signature(ns['main']).parameters['devices']"
            ".default is None; "
            "bad = sorted(m for m in sys.modules if m.startswith('jax') or "
            "m.split('.')[0] in ('watermarking_gpu_tpu', 'PIL')); "
            "print(bad); sys.exit(1 if bad else 0)")
    result = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                            capture_output=True, text=True, timeout=120)
    assert result.returncode == 0, result.stdout + result.stderr
    if not torch.cuda.is_available():
        result = subprocess.run(
            [sys.executable, "examples/multichip_watermark_torch.py"],
            cwd=REPO, capture_output=True, text=True, timeout=120)
        assert result.returncode != 0
        assert "no CUDA device" in result.stderr


def fake_nvcc(tmp_path: Path, body: str) -> Path:
    """A CUDA_HOME whose bin/nvcc is a shell script."""
    home = tmp_path / "cuda"
    (home / "bin").mkdir(parents=True)
    nvcc = home / "bin" / "nvcc"
    nvcc.write_text("#!/bin/sh\n" + body)
    nvcc.chmod(0o755)
    return home


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    with pytest.raises(build.KernelBuildError, match="nvcc"):
        build.build(build_root=tmp_path / "out")
    assert not (tmp_path / "out").exists()


def test_build_compiles_once_per_source_hash(tmp_path, monkeypatch):
    home = fake_nvcc(tmp_path, (
        'while [ $# -gt 0 ]; do [ "$1" = -o ] && out="$2"; shift; done\n'
        'echo "ptxas info : Used 40 registers" >&2\n: > "$out"\n'))
    monkeypatch.setenv("CUDA_HOME", str(home))
    path, log = build.build(build_root=tmp_path / "out")
    assert path.is_file() and path.parent.name == build.source_hash()
    assert "Used 40 registers" in log
    assert build.build(build_root=tmp_path / "out") == (path, "")


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    home = fake_nvcc(tmp_path, 'echo "error: bad kernel" >&2\nexit 2\n')
    monkeypatch.setenv("CUDA_HOME", str(home))
    with pytest.raises(build.KernelBuildError, match="bad kernel"):
        build.build(build_root=tmp_path / "out")
    assert not list((tmp_path / "out").rglob("*.so*"))


def test_cpu_tensors_launch_no_kernel():
    kernels.reset_launch_counts()
    rng = np.random.default_rng(2)
    frames = torch.from_numpy(np.clip(rng.normal(128, 40, (2, 24, 40)), 0,
                                      255).astype(np.float32))
    wm = torch.from_numpy(rng.normal(size=(24, 40)).astype(np.float32))
    for mask_type in ("me", "nvf"):
        for p in (3, 5):
            marked, _ = pipelines.embed_pipeline(frames, frames, wm, 2.55,
                                                 mask_type, p=p, impl="cuda")
            pipelines.detect_pipeline(marked, wm, mask_type, p=p,
                                      impl="cuda")
            pipelines.detect_many_pipeline(marked, torch.stack([wm, -wm]),
                                           mask_type, p=p, impl="cuda")
            kernels.prediction_error(frames, torch.zeros(2, p * p - 1), p)
            kernels.nvf_mask(frames, p)
    assert kernels.launch_counts() == {"me_gram_lags": 0,
                                       "me_gram_assemble": 0,
                                       "me_gram_solve8": 0,
                                       "wide_lag_strips": 0,
                                       "wide_assemble": 0,
                                       "embed_field": 0,
                                       "detect_partials": 0,
                                       "detect_many": 0,
                                       "prediction_error": 0,
                                       "nvf_mask": 0,
                                       "spd_solve8": 0,
                                       "spd_solve_wide": 0,
                                       "embed_finish": 0,
                                       "embed_chain": 0,
                                       "detect_chain": 0}


def test_cpu_tensors_keep_the_per_wrapper_route(monkeypatch):
    """CPU frames never take the one-call chain (``ops/cuda/chain.py``):
    ``applies`` says no at every mask and p, the pipelines run the plain
    versions with the chain counters at 0, and the chain's entry points
    refuse CPU frames before they touch the library. ``launch_counts``
    carries the chain counters and ``reset_launch_counts`` zeroes them."""
    from watermarking_gpu_tpu_torch.ops.cuda import chain

    monkeypatch.setattr(build, "library", lambda: pytest.fail(
        "the kernel library was loaded for CPU frames"))
    kernels.reset_launch_counts()
    rng = np.random.default_rng(3)
    frames = torch.from_numpy(np.clip(rng.normal(128, 40, (2, 30, 40)), 0,
                                      255).astype(np.float32))
    wm = torch.from_numpy(rng.normal(size=(30, 40)).astype(np.float32))
    for mask_type in ("me", "nvf"):
        for p in (3, 5, 7, 9):
            for image in (frames, frames[0]):
                assert not chain.applies(image, mask_type, p, detect=False)
                assert not chain.applies(image, mask_type, p, detect=True)
        marked, strength = pipelines.embed_pipeline(frames, frames, wm, 2.55,
                                                    mask_type, p=5,
                                                    impl="cuda")
        want = pipelines.embed_pipeline(frames, frames, wm, 2.55, mask_type,
                                        p=5, impl="torch")
        torch.testing.assert_close(marked, want[0], atol=0.1, rtol=0)
        torch.testing.assert_close(strength, want[1], rtol=2e-4, atol=0)
        pipelines.detect_pipeline(marked, wm, mask_type, p=3, impl="cuda")
    with pytest.raises(ValueError, match="CUDA frames"):
        chain.embed_chain(frames, frames, wm, 1.0, "me", 3)
    with pytest.raises(ValueError, match="CUDA frames"):
        chain.detect_chain(frames, wm, "nvf", 3)
    with pytest.raises(ValueError, match="mask_type"):
        chain.detect_chain(frames, wm, "xyz", 3)
    counts = kernels.launch_counts()
    assert counts["embed_chain"] == counts["detect_chain"] == 0
    assert not any(counts.values())
    kernels.embed_chain.launches = kernels.detect_chain.launches = 4
    assert kernels.launch_counts()["embed_chain"] == 4
    kernels.reset_launch_counts()
    assert kernels.launch_counts()["detect_chain"] == 0
    assert kernels.KERNELS["embed_chain"] is kernels.embed_chain


def test_cpu_tensors_count_no_nvf_launch():
    """CPU tensors launch no NVF kernel: ``embed_field.nvf`` and
    ``detect_partials.nvf`` stay 0 through the pipelines at every p and
    through the wrappers; ``launch_counts`` leaves them out and
    ``reset_launch_counts`` zeroes them."""
    kernels.reset_launch_counts()
    rng = np.random.default_rng(5)
    frames = torch.from_numpy(np.clip(rng.normal(128, 40, (2, 30, 40)), 0,
                                      255).astype(np.float32))
    wm = torch.from_numpy(rng.normal(size=(30, 40)).astype(np.float32))
    for p in (3, 5, 7, 9):
        marked, _ = pipelines.embed_pipeline(frames, frames, wm, 2.55, "nvf",
                                             p=p, impl="cuda")
        pipelines.detect_pipeline(marked, wm, "nvf", p=p, impl="cuda")
    kernels.embed_field(frames, wm, None, "nvf", 3)
    kernels.detect_partials(frames, wm, torch.full((2, 8), 0.125), "nvf", 3)
    assert kernels.embed_field.nvf == kernels.detect_partials.nvf == 0
    assert not any(kernels.launch_counts().values())
    assert set(kernels.launch_counts()) == set(kernels.KERNELS)
    kernels.embed_field.nvf = kernels.detect_partials.nvf = 2
    assert not any(kernels.launch_counts().values())
    kernels.reset_launch_counts()
    assert kernels.embed_field.nvf == kernels.detect_partials.nvf == 0


@pytest.mark.parametrize("mask_type, p, detect",
                         [("me", 3, False), ("me", 3, True), ("me", 9, False),
                          ("me", 5, True), ("nvf", 7, False),
                          ("nvf", 5, True)])
def test_chain_scratch_layout(monkeypatch, mask_type, p, detect):
    """The chain's one allocation a call: every buffer it needs for the
    mask, p and direction, each on a 16-byte boundary, none overlapping,
    of the size its kernel writes (the kernels' block counts from the
    library, stood in for here by the tile counts of a 64 x 64 tile)."""
    from watermarking_gpu_tpu_torch.ops.cuda import chain
    from watermarking_gpu_tpu_torch.ops.me import lag_plan

    monkeypatch.setattr(build, "num_blocks", lambda name, rows, cols, *_: (
        -(-rows // 64)) * -(-cols // 64))
    batch, rows, cols = 3, 100, 200
    plan = chain._Plan(batch, rows, cols, mask_type, p, detect,
                       torch.device("cpu"))
    pred_p = 3 if mask_type == "nvf" else p
    analysis = mask_type == "me" or detect
    tiles = 2 * 4
    want = {"partials": batch * tiles * (3 if detect else 2) * 4,
            "done": batch * 4, "valid": batch}
    if not detect:
        want.update(u_raw=batch * rows * cols * 4, totals=2 * batch * 4)
    if analysis:
        k = pred_p * pred_p - 1
        n_lags = len(lag_plan(pred_p)[0])
        want.update(gram=batch * (k + 1) ** 2 * 4, coefficients=batch * k * 4,
                    sums=batch * n_lags * plan.n_strips * plan.n_blocks * 4)
        if pred_p > 3:
            want["edges"] = batch * n_lags * plan.n_strips * 4 * (p // 2) * 4
            assert plan.bank_rows.tolist()[:p // 2 + 1] == [0] * (p // 2 + 1)
    assert set(plan.offsets) == set(want)
    assert plan.pred_p == (pred_p if analysis else 0)
    spans = sorted((plan.offsets[name], plan.offsets[name] + size)
                   for name, size in want.items())
    assert all(start % 16 == 0 for start, _ in spans)
    assert all(a_end <= b_start for (_, a_end), (b_start, _) in
               zip(spans, spans[1:]))
    assert spans[-1][1] <= plan.nbytes < spans[-1][1] + 16
    pointers = plan.pointers(1 << 20, ("u_raw", "edges", "done"))
    assert pointers[2] == (1 << 20) + plan.offsets["done"]
    assert (pointers[0] is None) == detect
    assert (pointers[1] is None) == (pred_p == 3 or not analysis)


def test_wrappers_raise_on_other_devices():
    frames = torch.zeros(1, 8, 8, device="meta")
    wm = torch.zeros(8, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        kernels.me_gram(frames)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        kernels.me_gram_lags(frames)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        kernels.me_gram_solve8(frames)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        kernels.me_gram_assemble(torch.zeros(1, 13, 1, 1, device="meta"),
                                 frames)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        kernels.embed_field(frames, wm, None, "nvf")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        kernels.detect_partials(frames, wm, torch.zeros(1, 8,
                                                        device="meta"))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        kernels.wide_lag_strips(torch.zeros(1, 16, 16, device="meta"), 5)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        kernels.wide_assemble(torch.zeros(1, 41, 1, 1, device="meta"),
                              torch.zeros(1, 41, 1, 8, device="meta"),
                              torch.zeros(1, 8, 16, device="meta"),
                              torch.zeros(1, 8, 16, device="meta"), 5, 16)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        kernels.detect_many_partials(frames, wm[None],
                                     torch.zeros(1, 8, device="meta"))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        kernels.prediction_error(frames, torch.zeros(1, 8, device="meta"))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        kernels.nvf_mask(frames)
    # coefficients that do not match the image's batch or p raise on every
    # device, before the device is looked at
    for image, wrong in ((frames, torch.zeros(1, 24, device="meta")),
                         (frames[0], torch.zeros(1, 8, device="meta")),
                         (torch.zeros(1, 8, 8), torch.zeros(2, 8)),
                         (torch.zeros(8, 8), torch.zeros(24))):
        with pytest.raises(ValueError, match="coefficients"):
            kernels.prediction_error(image, wrong)


@pytest.mark.parametrize("p", [5, 7, 9])
def test_wide_windows_are_not_ported(p):
    """The wide windows construct and run (the name is the refusal test's
    this replaced); window sizes outside {3, 5, 7, 9} raise ValueError."""
    for engine in (Watermark, BatchedWatermark):
        assert engine(16, 16, 3, p=p, device="cpu").p == p
        with pytest.raises(ValueError, match="Wrong p"):
            engine(16, 16, 3, p=p + 1, device="cpu")
    image = torch.arange(256.0).reshape(16, 16) % 7 * 30
    marked, strength = pipelines.embed_pipeline(image, image, image, 2.55,
                                                "nvf", p=p)
    assert marked.shape == (16, 16) and torch.isfinite(strength)
    with pytest.raises(ValueError, match="p must be one of"):
        pipelines.detect_pipeline(image, image, "me", p=p - 1)
    with pytest.raises(ValueError, match="wide Gram takes p"):
        kernels.me_gram_wide(image[None], 3)


def test_engines_default_to_the_card():
    """Entry points run on the card unless the caller asks for the CPU
    (checked from the signatures: building an engine here would need one)."""
    for fn in (Watermark.__init__, Watermark.from_state,
               BatchedWatermark.__init__, BatchedWatermark.from_state):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_kernel_sources_ship_with_the_package():
    # source -> what its Replaces: header names in the JAX package
    sources = {name: "ops/pallas/" for name in (
        "me_gram.cu", "me_gram_wide.cu", "fused.cu", "detect_many.cu",
        "predict.cu", "nvf.cu")}
    sources["embed_finish.cu"] = "ops/pipelines.py::_embed_pipeline_fused"
    names = {p.name for p in (PACKAGE / "csrc").iterdir()}
    assert {*sources, "common.cuh", "stencil.cuh"} <= names
    for name, replaced in sources.items():
        head = (PACKAGE / "csrc" / name).read_text()[:1500]
        assert "Replaces:" in head and replaced in head
    assert os.fspath(build.CSRC_DIR) == os.fspath(PACKAGE / "csrc")
