#!/usr/bin/env python3
"""A/B timing of the wide solve kernel (``spd_solve_wide_kernel<k>``, k =
24, 48, 80) on one GPU: builds of
``watermarking_gpu_tpu_torch/csrc/spd_solve.cu`` against each other.

    python3 tools/ab_wide_solve.py [--parent SOURCE] [name=SOURCE ...]

Builds: ``parent``, the source at git's HEAD (``git show``; where the
checkout has no git history, pass a copy with ``--parent``), ``new``, the
package's source, and each ``name=SOURCE``. Every build is a shared library
of its own, all ``nvcc`` processes started together; ptxas' registers,
shared memory and spills are printed per kernel.

Inputs at p = 5, 7, 9: the wide Grams of ``chip_smoke.py``'s frames (8 x
1080 x 1920, from the package's Gram kernels) and random SPD systems of a
frame Gram's conditioning (``chip_smoke.random_spd_grams``, ridge 1e5, the
seeds of its phase 2) at B = 1, 8 and 300. For each input and build: device
ms a call, CUDA events around 20 calls after 3, queued behind ~1 ms of
``torch.cuda._sleep`` so that the host's launches do not set the pace, the
builds in turns (in order, then reversed; min/max printed); the largest
difference from the plain blocked solve (``ops.me.
solve_coefficients_spd_blocked``, TF32 off) and each one's error against a
float64 ``torch.linalg.solve`` of the same systems; whether the valid flags
equal the plain version's; and whether the coefficients are bit-identical
to the first build's. Needs a GPU and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from watermarking_gpu_tpu_torch.ops import cuda as kernels  # noqa: E402
from watermarking_gpu_tpu_torch.ops.cuda import build  # noqa: E402

SOURCE = "watermarking_gpu_tpu_torch/csrc/spd_solve.cu"
KERNEL_NAMES = ("spd_solve_wide_kernel", "spd_solve8_kernel")
SLEEP_CYCLES = 2_000_000    # ~1 ms at the H100's clocks
WIDE_P = (5, 7, 9)
BATCHES = (1, 8, 300)       # 300: more blocks than the card has SMs
_PTR, _INT = ctypes.c_void_p, ctypes.c_int


def parent_source(out: Path) -> str:
    """The source at git's HEAD, written into ``out``."""
    text = subprocess.run(["git", "-C", str(ROOT), "show", f"HEAD:{SOURCE}"],
                          capture_output=True, text=True, check=True).stdout
    path = out / "spd_solve_parent.cu"
    path.write_text(text)
    return str(path)


def build_all(sources: dict[str, str], out: Path) -> dict[str, ctypes.CDLL]:
    """One shared library a source, all nvcc started together; prints
    ptxas' report of each kernel."""
    nvcc = build.find_nvcc()
    processes = {
        name: subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-shared", "-I", str(build.CSRC_DIR),
             "-o", str(out / f"{name}.so"), source],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, source in sources.items()}
    libraries = {}
    for name, process in processes.items():
        log = process.communicate()[0]
        if process.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{log}")
        lines = log.splitlines()
        for i, line in enumerate(lines):
            kernel = next((k for k in KERNEL_NAMES if k in line), None)
            if "Compiling entry" in line and kernel:
                report = [x.split(":", 1)[-1].strip()
                          for x in lines[i + 1:i + 4]
                          if "Used" in x or "spill" in x]
                k = re.search(r"ILi(\d+)E", line)
                label = f"{kernel}<{k.group(1)}>" if k else kernel
                print(f"{name} {label}: {' / '.join(report)}", flush=True)
        library = ctypes.CDLL(str(out / f"{name}.so"))
        library.wm_spd_solve_wide.argtypes = (*[_PTR] * 3, _INT, _INT, _PTR)
        library.wm_spd_solve_wide.restype = ctypes.c_int
        libraries[name] = library
    return libraries


def solver(library, gram: torch.Tensor):
    """A call of ``library``'s wide solve on ``gram`` into outputs held
    between calls; returns (call, coefficients, valid)."""
    batch, k = gram.shape[0], gram.shape[-1] - 1
    coefficients = torch.empty((batch, k), device=gram.device)
    valid = torch.empty(batch, dtype=torch.bool, device=gram.device)

    def call():
        code = library.wm_spd_solve_wide(
            gram.data_ptr(), coefficients.data_ptr(), valid.data_ptr(),
            batch, k, torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"wm_spd_solve_wide: CUDA error {code}")
    return call, coefficients, valid


def device_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device ms a call: CUDA events around ``iters`` calls queued behind
    a sleep kernel, so that the events time the calls back to back."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def inputs(p: int) -> dict[str, torch.Tensor]:
    k = p * p - 1
    frames = torch.from_numpy(chip_smoke.make_frames()).cuda()
    grams = {f"frames B={frames.shape[0]}": kernels.me_gram_wide(frames, p)}
    for batch in BATCHES:
        grams[f"random B={batch}"] = chip_smoke.random_spd_grams(
            batch, batch + p, k, ridge=1e5)
    return grams


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", help="the parent's spd_solve.cu "
                        "(default: git show HEAD:...)")
    parser.add_argument("builds", nargs="*", help="name=SOURCE")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("needs a GPU: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    with tempfile.TemporaryDirectory() as tmp:
        sources = {"parent": args.parent or parent_source(Path(tmp)),
                   "new": str(ROOT / SOURCE),
                   **dict(arg.split("=", 1) for arg in args.builds)}
        libraries = build_all(sources, Path(tmp))
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"],
                             capture_output=True, text=True)
        print(smi.stdout.strip(), flush=True)
        for p in WIDE_P:
            k = p * p - 1
            for label, gram in inputs(p).items():
                want, want_valid = kernels.spd_solve_wide_plain(gram)
                ok = want_valid
                exact = torch.zeros_like(want, dtype=torch.float64)
                exact[ok] = torch.linalg.solve(
                    gram[ok, :k, :k].double(), gram[ok, :k, k].double())

                def f64_err(coefficients):
                    return float((coefficients[ok].double()
                                  - exact[ok]).abs().max())

                calls = {name: solver(library, gram)
                         for name, library in libraries.items()}
                for call, _, _ in calls.values():
                    call()
                torch.cuda.synchronize()
                first = next(iter(calls.values()))[1].clone()
                results = {name: (coefficients.clone(), valid.clone())
                           for name, (_, coefficients, valid)
                           in calls.items()}
                times = {name: [] for name in calls}
                for name in [*calls, *reversed(calls)]:
                    times[name].append(device_ms(calls[name][0]))
                parts = []
                for name, (coefficients, valid) in results.items():
                    parts.append(
                        f"{name} {min(times[name]):.5f}/"
                        f"{max(times[name]):.5f} ms, abs "
                        f"{float((coefficients - want).abs().max()):.2e} "
                        f"from the plain solve, f64 err "
                        f"{f64_err(coefficients):.2e}, valid "
                        + ("equal" if torch.equal(valid, want_valid)
                           else f"{valid.tolist()} against "
                                f"{want_valid.tolist()}")
                        + (", bit-identical to " if torch.equal(
                            coefficients, first) else ", differs from ")
                        + f"{next(iter(results))}'s")
                print(f"k={k} {label}: plain f64 err {f64_err(want):.2e}; "
                      + "; ".join(parts), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
