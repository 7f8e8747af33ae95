#!/usr/bin/env python3
"""A/B timing of builds of the multi-candidate detect kernel on one GPU.

    python3 tools/ab_detect_many.py new= old=path/to/detect_many.cu@ \\
        nofma=-DSOME_MACRO=1

Each argument is ``name=[source@]flags``: the kernel source (default
``watermarking_gpu_tpu_torch/csrc/detect_many.cu``) built by its own ``nvcc``
into a shared library with the extra compiler flags, all builds started
together. Every build is called through its C entry point ``wm_detect_many``
on ``chip_smoke.py``'s frames and 64-candidate bank (8 x 1080 x 1920), at ME
and NVF p = 3, 5, 7, 9; its partial sums are held to the first build's
(largest relative difference printed) and it is timed with CUDA events, 5
calls after 1, in turns (every build in order, then in reverse), so that
builds compare within one call on one card. Prints ptxas' registers, shared
memory and spills per instantiation. Needs a GPU and nvcc; imports nothing of
JAX.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from watermarking_gpu_tpu_torch.ops.cuda import build  # noqa: E402

SLOTS = 2 * 64 + 1  # the kernel's partials per block: chunk of 64 candidates


def build_variants(specs: dict[str, str], out: Path) -> dict[str, ctypes.CDLL]:
    nvcc = build.find_nvcc()
    processes = {}
    for name, spec in specs.items():
        source = str(build.CSRC_DIR / "detect_many.cu")
        if "@" in spec:
            source, spec = spec.split("@", 1)
        command = [nvcc, *build.NVCC_FLAGS, "-shared", *spec.split(), "-I",
                   str(build.CSRC_DIR), "-o", str(out / f"{name}.so"), source]
        processes[name] = subprocess.Popen(command, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True)
    libraries = {}
    for name, process in processes.items():
        log = process.communicate()[0]
        if process.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{log}")
        lines = log.splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry" in line and "detect_many_kernel" in line:
                report = [x.split(":")[-1].strip() for x in lines[i + 1:i + 4]
                          if "Used" in x or "spill" in x]
                template = line.split("detect_many_kernel")[1][:16]
                print(f"{name} {template}: {' / '.join(report)}", flush=True)
        library = ctypes.CDLL(str(out / f"{name}.so"))
        library.wm_detect_many.argtypes = (*[ctypes.c_void_p] * 4,
                                           *[ctypes.c_int] * 6,
                                           ctypes.c_void_p)
        libraries[name] = library
    return libraries


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a GPU: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    specs = dict(arg.split("=", 1) for arg in sys.argv[1:])
    with tempfile.TemporaryDirectory() as tmp:
        libraries = build_variants(specs, Path(tmp))
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"],
                             capture_output=True, text=True)
        print(smi.stdout.strip(), flush=True)
        frames = torch.from_numpy(chip_smoke.make_frames()).cuda()
        bank = torch.from_numpy(chip_smoke.make_bank()).cuda()
        coeffs = chip_smoke.predictor_coefficients(frames)
        batch, rows, cols = frames.shape
        n = bank.shape[0]
        tiles = -(-cols // 64) * -(-rows // 32)

        def run(library, mask: str, p: int, c: torch.Tensor,
                out: torch.Tensor) -> None:
            code = library.wm_detect_many(
                frames.data_ptr(), bank.data_ptr(), c.data_ptr(),
                out.data_ptr(), batch, n, rows, cols,
                0 if mask == "me" else 1, p,
                torch.cuda.current_stream().cuda_stream)
            if code:
                raise RuntimeError(f"wm_detect_many: CUDA error {code}")

        for p in chip_smoke.ALL_P:
            for mask in ("me", "nvf"):
                c = coeffs[p if mask == "me" else 3].contiguous()
                out = torch.empty((batch, -(-n // 64), tiles, SLOTS),
                                  device="cuda")
                sums = {}
                for name, library in libraries.items():
                    run(library, mask, p, c, out)
                    sums[name] = out.sum(dim=2)
                first = next(iter(sums.values()))
                diffs = {name: float(((s - first).abs()
                                      / first.abs().clamp_min(1e-3)).max())
                         for name, s in sums.items()}
                times = {name: [] for name in libraries}
                for name in [*libraries, *reversed(libraries)]:
                    times[name].append(chip_smoke.cuda_ms(
                        lambda: run(libraries[name], mask, p, c, out),
                        iters=5, warmup=1))
                print(f"{mask} p={p}: " + "; ".join(
                    f"{name} {min(t):.4f}/{max(t):.4f} ms (rel "
                    f"{diffs[name]:.1e})" for name, t in times.items()),
                    flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
