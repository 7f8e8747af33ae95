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
            "watermarking_gpu_tpu_torch.__main__; "
            "bad = sorted(m for m in sys.modules if m.startswith('jax') or "
            "m.split('.')[0] in ('watermarking_gpu_tpu', 'PIL')); "
            "print(bad); sys.exit(1 if bad else 0)")
    result = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                            capture_output=True, text=True, timeout=120)
    assert result.returncode == 0, result.stdout + result.stderr


def test_sources_name_no_jax():
    """Nor import Pillow; chip_smoke.py imports none of the three."""
    pattern = re.compile(r"^\s*(import|from)\s+(jax|PIL)\b"
                         r"|watermarking_gpu_tpu\b")
    sources = [path for suffix in ("*.py", "*.cu", "*.cuh")
               for path in PACKAGE.rglob(suffix)]
    offenders = [f"{path}:{n}" for path in sources
                 for n, line in enumerate(path.read_text().splitlines(), 1)
                 if pattern.search(line)]
    assert len(sources) > 10
    assert offenders == []
    imports = re.compile(r"^\s*(import|from)\s+(jax|PIL|watermarking_gpu_tpu)"
                         r"\b")
    smoke = (REPO / "chip_smoke.py").read_text().splitlines()
    assert [line for line in smoke if imports.search(line)] == []


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
                                       "wide_lag_strips": 0,
                                       "wide_assemble": 0,
                                       "embed_field": 0,
                                       "detect_partials": 0,
                                       "detect_many": 0,
                                       "prediction_error": 0,
                                       "nvf_mask": 0}


def test_wrappers_raise_on_other_devices():
    frames = torch.zeros(1, 8, 8, device="meta")
    wm = torch.zeros(8, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        kernels.me_gram(frames)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        kernels.me_gram_lags(frames)
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
                              torch.zeros(1, 16, 16, device="meta"), 5)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        kernels.detect_many_partials(frames, wm[None],
                                     torch.zeros(1, 8, device="meta"))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        kernels.prediction_error(frames, torch.zeros(1, 8, device="meta"))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        kernels.nvf_mask(frames)


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
    sources = ("me_gram.cu", "me_gram_wide.cu", "fused.cu", "detect_many.cu",
               "predict.cu", "nvf.cu")
    names = {p.name for p in (PACKAGE / "csrc").iterdir()}
    assert {*sources, "common.cuh"} <= names
    for name in sources:
        head = (PACKAGE / "csrc" / name).read_text()[:1500]
        assert "Replaces:" in head and "ops/pallas/" in head
    assert os.fspath(build.CSRC_DIR) == os.fspath(PACKAGE / "csrc")
