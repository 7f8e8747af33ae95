"""Build and load the port's CUDA kernels (``watermarking_gpu_tpu_torch/csrc``).

The kernels have a plain C interface, so they build with ``nvcc`` alone —
no PyTorch headers, which keeps the build to seconds — into one shared
library that is loaded with ``ctypes``. Each source compiles in its own
``nvcc`` process, all started together, and one more links them:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler
         -fPIC -Xptxas -v -c -o <name>.o csrc/<name>.cu     (one per source)
    nvcc -gencode arch=compute_90a,code=sm_90a -shared -o libwm_kernels.so *.o

The library goes to ``watermarking_gpu_tpu_torch/_build/<hash>/``, keyed by a
hash of the sources and the flags, at the first launch in a process. Every C
entry point launches on the stream it is given (PyTorch's current stream)
and returns ``cudaGetLastError()``; ``launch`` raises when that is not 0.
There is no fallback: without ``nvcc``, or when the build fails, ``library``
raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_ROOT = PACKAGE_DIR / "_build"
LIBRARY_NAME = "libwm_kernels.so"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_PTR = ctypes.c_void_p
_INT = ctypes.c_int
_FLOAT = ctypes.c_float
# C entry point -> argument types (pointers and the stream as c_void_p, so
# ctypes does not cut 64-bit addresses to int; a float as c_float)
SIGNATURES = {
    "wm_me_gram_lags": (_PTR, _PTR, _PTR, _INT, _INT, _INT, _INT, _INT,
                        _INT, _INT, _PTR, _PTR),
    "wm_me_gram_assemble": (_PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _INT, _INT,
                            _INT, _INT, _INT, _INT, _PTR, _PTR, _PTR, _PTR),
    "wm_wide_lag_strips": (_PTR, _PTR, _PTR, _PTR, _INT, _INT, _INT, _INT,
                           _INT, _INT, _INT, _INT, _INT, _INT, _PTR),
    "wm_wide_assemble": (_PTR, _PTR, _INT, _PTR, _PTR, _PTR, _PTR, _PTR,
                         _PTR, _INT, _INT, _INT, _INT, _INT, _INT, _INT,
                         _PTR),
    "wm_embed_field_num_blocks": (_INT, _INT, _INT, _INT),
    "wm_embed_field": (_PTR, _PTR, _PTR, _PTR, _PTR, _INT, _INT, _INT, _INT,
                       _INT, _INT, _INT, _PTR),
    "wm_detect_partials_num_blocks": (_INT, _INT),
    "wm_detect_partials": (_PTR, _PTR, _PTR, _PTR, _INT, _INT, _INT, _INT,
                           _INT, _INT, _INT, _INT, _INT, _PTR),
    "wm_detect_many_chunk": (),
    "wm_detect_many_cluster": (_INT, _INT, _INT),
    "wm_detect_many_num_blocks": (_INT, _INT),
    "wm_detect_many": (_PTR, _PTR, _PTR, _PTR, _INT, _INT, _INT, _INT, _INT,
                       _INT, _INT, _INT, _INT, _INT, _PTR),
    "wm_prediction_error": (_PTR, _PTR, _PTR, _INT, _INT, _INT, _INT, _PTR),
    "wm_nvf_mask": (_PTR, _PTR, _INT, _INT, _INT, _INT, _PTR),
    "wm_spd_solve8": (_PTR, _PTR, _PTR, _INT, _PTR),
    "wm_spd_solve_wide": (_PTR, _PTR, _PTR, _INT, _INT, _PTR),
    "wm_embed_finish": (_PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _INT, _INT,
                        _INT, _FLOAT, _INT, _INT, _PTR),
    "wm_embed_chain": (_INT, _PTR, _PTR, _PTR, _PTR, _PTR, _INT, _INT, _INT,
                       _INT, _INT, _INT, _INT, _FLOAT, _INT, _PTR, _PTR, _PTR,
                       _PTR, _PTR, _INT, _INT, _INT, _INT, _INT, _PTR, _PTR,
                       _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR),
    "wm_detect_chain": (_INT, _PTR, _PTR, _PTR, _INT, _INT, _INT, _INT, _INT,
                        _INT, _PTR, _PTR, _PTR, _PTR, _PTR, _INT, _INT, _INT,
                        _INT, _INT, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR,
                        _PTR),
}


class KernelBuildError(RuntimeError):
    """The CUDA kernels could not be built or loaded."""


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin`` (default ``/usr/local/cuda``),
    then ``PATH``."""
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH): the CUDA "
            "kernels of watermarking_gpu_tpu_torch are built from "
            "csrc/*.cu at first use and need the CUDA toolkit")
    return found


def source_hash() -> str:
    """Hash of the kernel sources and the compiler flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC_DIR.glob("*.cu*")):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    return digest.hexdigest()[:16]


def build(build_root: Path = BUILD_ROOT) -> tuple[Path, str]:
    """Compile the kernels if this source hash has no library yet.

    Returns (library path, compiler output — ptxas' register and shared
    memory report per kernel; empty when the library was already built).
    """
    out_dir = build_root / source_hash()
    library_path = out_dir / LIBRARY_NAME
    if library_path.is_file():
        return library_path, ""
    nvcc = find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    sources = sorted(CSRC_DIR.glob("*.cu"))
    objects = [out_dir / f"{src.stem}.{tag}.o" for src in sources]
    partial = out_dir / f"{LIBRARY_NAME}.{tag}"
    commands = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                for src, obj in zip(sources, objects)]
    try:
        processes = [subprocess.Popen(command, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
                     for command in commands]
        logs = [process.communicate()[0] for process in processes]
        link = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(partial),
                *map(str, objects)]
        failed = [(command, process.returncode, log) for command, process, log
                  in zip(commands, processes, logs) if process.returncode]
        if not failed:
            result = subprocess.run(link, capture_output=True, text=True)
            logs.append(result.stdout + result.stderr)
            if result.returncode:
                failed = [(link, result.returncode, logs[-1])]
        if failed:
            raise KernelBuildError("\n".join(
                f"nvcc failed ({code}): {' '.join(command)}\n{log}"
                for command, code, log in failed))
        os.replace(partial, library_path)  # atomic next to concurrent builds
    finally:
        for path in (*objects, partial):
            path.unlink(missing_ok=True)
    return library_path, "".join(logs)


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call in a process)."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def launch(name: str, device: torch.device, *args) -> None:
    """Call C entry point ``name`` on ``device``'s current stream; raise if
    the launch was refused."""
    launch_many(device, (name, args))


def launch_many(device: torch.device, *calls: tuple[str, tuple]) -> None:
    """Call each (C entry point, arguments) of ``calls`` in order on
    ``device``'s current stream, in one device context with one lookup of
    the stream (the host's cost of a launch, which paces the small
    kernels); raise at the first launch that was refused, before the
    next."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        lib = library()
        for name, args in calls:
            code = getattr(lib, name)(*args, stream)
            if code != 0:
                raise RuntimeError(f"{name}: CUDA error {code} at launch")


def raw_stream(index: int) -> int:
    """The handle of ``cuda:index``'s current stream, as a C entry point
    takes it: PyTorch's raw getter where the build has one (no
    ``torch.cuda.Stream`` object a call), else the public API."""
    getter = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if getter is not None:
        return getter(index)
    return torch.cuda.current_stream(index).cuda_stream


def num_blocks(name: str, *dims: int) -> int:
    """Blocks per frame of kernel ``name``'s grid (its partials' dim 1), for
    the dims its C function takes: (rows, cols), and for the embed field,
    whose grid depends on them, the mask type and p."""
    return int(getattr(library(), f"{name}_num_blocks")(*dims))


def check_input(name: str, tensor: torch.Tensor, shape: tuple,
                device: torch.device) -> None:
    """Raise unless ``tensor`` is a contiguous f32 tensor of ``shape`` on
    ``device`` (what the kernels take)."""
    if tensor.device != device:
        raise ValueError(f"{name} is on {tensor.device}, expected {device}")
    if tensor.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {tensor.dtype}")
    if tuple(tensor.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(tensor.shape)}")
    if not tensor.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
