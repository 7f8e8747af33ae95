#!/usr/bin/env python3
"""A/B timing of builds of the standalone prediction error and NVF mask
kernels (``prediction_error_kernel<PH>``, ``nvf_mask_kernel<NH>``) on one
GPU.

    python3 tools/ab_standalone.py [name=[DIR@]flags ...]

Each argument is ``name=[DIR@]flags``: ``predict.cu`` and ``nvf.cu`` of
directory DIR (default ``watermarking_gpu_tpu_torch/csrc``; they include
the headers beside them) built by one ``nvcc`` into a shared library with
the extra compiler flags, all builds started together. DIR ``git:REV``
takes the kernel sources and headers at git revision REV (``git show``)
into a temporary directory; where the checkout has no git history (the GPU
machine's copy), unpack them into a directory first. With no arguments
the builds are ``parent=git:HEAD@ new=``. Prints ptxas' registers, shared
memory and spills per instantiation.

Every build is called through its C entry points ``wm_prediction_error``
and ``wm_nvf_mask`` on ``chip_smoke.py``'s frames (8 x 1080 x 1920) at p =
3, 5, 7, 9, the prediction error with seeded random coefficients. Its
output must equal the plain version's (``prediction_error_plain``,
``nvf_mask_plain``) and the first build's bit for bit, and its two calls
must give the same bits. It is timed in turns (every build in order, then
in reverse), so that builds compare within one call on one card: CUDA
events around 20 calls after 3, then the kernel's device time a call from
a ``torch.profiler`` session over 20 calls, in the same turns, with the
launch's registers, shared memory and blocks per SM from its trace. Beside
them: ``chip_smoke.kernel_bound``'s bound and, for the prediction error,
the floor of its 2(p*p-1) rounded f32 instructions a pixel; once, the
time of a ``Tensor.copy_`` of the frames, which moves the same 8 bytes a
pixel. Needs a GPU and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from watermarking_gpu_tpu_torch.ops.cuda import build  # noqa: E402
from watermarking_gpu_tpu_torch.ops.cuda.nvf import \
    nvf_mask_plain  # noqa: E402
from watermarking_gpu_tpu_torch.ops.cuda.predict import \
    prediction_error_plain  # noqa: E402

CSRC = "watermarking_gpu_tpu_torch/csrc"
SOURCES = ("predict.cu", "nvf.cu")
KERNELS = {"prediction_error": "prediction_error_kernel",
           "nvf_mask": "nvf_mask_kernel"}
ENTRIES = {"wm_prediction_error": (ctypes.c_void_p,) * 3
           + (ctypes.c_int,) * 4 + (ctypes.c_void_p,),
           "wm_nvf_mask": (ctypes.c_void_p,) * 2 + (ctypes.c_int,) * 4
           + (ctypes.c_void_p,)}
# f32 instructions a second: 132 SMs x 128 lanes x 1.98 GHz, the rate
# behind the data sheet's 67 TFLOP/s of fused multiply-adds
F32_INSTRUCTIONS_PER_S = chip_smoke.F32_FLOPS_PER_S / 2


def git_sources(rev: str, out: Path) -> Path:
    """The kernel sources and headers of ``CSRC`` at git revision ``rev``,
    written into ``out``."""
    names = subprocess.run(
        ["git", "-C", str(ROOT), "ls-tree", "--name-only", f"{rev}:{CSRC}"],
        capture_output=True, text=True, check=True).stdout.split()
    out.mkdir(parents=True)
    for name in names:
        if name.endswith((".cu", ".cuh")):
            (out / name).write_text(subprocess.run(
                ["git", "-C", str(ROOT), "show", f"{rev}:{CSRC}/{name}"],
                capture_output=True, text=True, check=True).stdout)
    return out


def build_variants(specs: dict[str, str], out: Path) -> dict[str, ctypes.CDLL]:
    """Build each ``name=[DIR@]flags`` spec into its own library, all
    ``nvcc`` processes started together, and print ptxas' registers, shared
    memory and spills of each instantiation."""
    nvcc = build.find_nvcc()
    processes = {}
    for name, spec in specs.items():
        directory = build.CSRC_DIR
        if "@" in spec:
            where, spec = spec.split("@", 1)
            directory = (git_sources(where[4:], out / f"{name}_src")
                         if where.startswith("git:") else Path(where))
        command = [nvcc, *build.NVCC_FLAGS, "-shared", *spec.split(), "-o",
                   str(out / f"{name}.so"),
                   *(str(directory / source) for source in SOURCES)]
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
            kernel = next((k for k in KERNELS.values() if k in line), None)
            if "Compiling entry" in line and kernel:
                report = [x.split(":", 1)[-1].strip()
                          for x in lines[i + 1:i + 4]
                          if "Used" in x or "spill" in x]
                half = re.search(r"ILi(\d+)E", line)
                label = f"{kernel}<{half.group(1)}>" if half else kernel
                print(f"{name} {label}: {' / '.join(report)}", flush=True)
        library = ctypes.CDLL(str(out / f"{name}.so"))
        for entry, argtypes in ENTRIES.items():
            getattr(library, entry).argtypes = argtypes
        libraries[name] = library
    return libraries


def device_run(fn, kernel: str, out: Path, calls: int = 20,
               tries: int = 3) -> tuple[float, str]:
    """``kernel``'s device ms a call over ``calls`` calls of ``fn`` in one
    torch.profiler session, and its launch's registers, shared memory and
    blocks per SM, from the session's trace. The profiler may drop
    records, so the mean is over the records it kept, and a session that
    kept none is run again."""
    for _ in range(tries):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        path = out / "trace.json"
        prof.export_chrome_trace(str(path))
        records = [event for event in json.loads(path.read_text())[
            "traceEvents"] if event.get("cat") == "kernel"
            and kernel in event.get("name", "")]
        if records:
            args = records[0].get("args", {})
            return (sum(event["dur"] for event in records) / 1e3
                    / len(records),
                    ", ".join(f"{key} {args[key]}" for key in (
                        "registers per thread", "shared memory",
                        "blocks per SM") if key in args))
    raise SystemExit(f"the profiler kept no {kernel} record in {tries} "
                     f"sessions")


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a GPU: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    specs = dict(arg.split("=", 1) for arg in sys.argv[1:]) or {
        "parent": "git:HEAD@", "new": ""}
    with tempfile.TemporaryDirectory() as tmp:
        libraries = build_variants(specs, Path(tmp))
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"],
                             capture_output=True, text=True)
        print(smi.stdout.strip(), flush=True)
        frames = torch.from_numpy(chip_smoke.make_frames()).cuda()
        batch, rows, cols = frames.shape
        stream = torch.cuda.current_stream().cuda_stream

        def run(library, op: str, p: int, coeffs: torch.Tensor,
                out: torch.Tensor) -> None:
            code = (library.wm_prediction_error(
                frames.data_ptr(), coeffs.data_ptr(), out.data_ptr(), batch,
                rows, cols, p, stream) if op == "prediction_error" else
                library.wm_nvf_mask(frames.data_ptr(), out.data_ptr(), batch,
                                    rows, cols, p, stream))
            if code:
                raise RuntimeError(f"{op}: CUDA error {code}")

        cases = [(op, p) for p in chip_smoke.ALL_P for op in KERNELS]
        outs, coeffs, events = {}, {}, {}
        for op, p in cases:
            coeffs[p] = torch.from_numpy(np.random.default_rng(p).normal(
                0, 0.1, (batch, p * p - 1)).astype(np.float32)).cuda()
            want = (prediction_error_plain(frames, coeffs[p], p)
                    if op == "prediction_error" else
                    nvf_mask_plain(frames, p))
            for name, library in libraries.items():
                out = torch.empty_like(frames)
                outs[(name, op, p)] = out
                run(library, op, p, coeffs[p], out)
                again = out.clone()
                run(library, op, p, coeffs[p], out)
                if not torch.equal(again, out):
                    raise SystemExit(f"{name} {op} p={p}: two calls differ")
                if not torch.equal(out, want):
                    raise SystemExit(
                        f"{name} {op} p={p}: not bit-identical to the plain "
                        f"version, max abs err "
                        f"{float((out - want).abs().max()):.3e}")
            del want
            for name in [*libraries, *reversed(libraries)]:
                events.setdefault((name, op, p), []).append(
                    chip_smoke.cuda_ms(lambda: run(
                        libraries[name], op, p, coeffs[p],
                        outs[(name, op, p)])))
        # the card's own rate for these bytes: one PyTorch copy of the
        # frames reads and writes what either kernel must, 8 bytes a pixel
        copy = torch.empty_like(frames)
        copy_ms = [chip_smoke.cuda_ms(lambda: copy.copy_(frames))
                   for _ in range(2)]
        print(f"a copy of the frames (Tensor.copy_, events): "
              f"{min(copy_ms):.4f}/{max(copy_ms):.4f} ms", flush=True)
        pixels = batch * rows * cols
        # the profiler after every CUDA-event timing (it may slow launches)
        for op, p in cases:
            device, launch = {}, {}
            for name in [*libraries, *reversed(libraries)]:
                ms, launch[name] = device_run(
                    lambda n=name: run(libraries[n], op, p, coeffs[p],
                                       outs[(n, op, p)]), KERNELS[op],
                    Path(tmp))
                device.setdefault(name, []).append(ms)
            bound_ms, bound_by = chip_smoke.kernel_bound(op, "me", p)
            floor = ""
            if op == "prediction_error":
                floor_ms = (2 * (p * p - 1) * pixels
                            / F32_INSTRUCTIONS_PER_S * 1e3)
                floor = f", rounded-pair floor {floor_ms:.4f} ms"
            print(f"{op} p={p}: " + "; ".join(
                f"{name} device {min(device[name]):.4f}/"
                f"{max(device[name]):.4f} ms, events "
                f"{min(events[(name, op, p)]):.4f}/"
                f"{max(events[(name, op, p)]):.4f} ms"
                for name in libraries)
                + f" (bit-identical to the plain version); bound "
                f"{bound_ms:.4f} ms ({bound_by}){floor}", flush=True)
            for name in libraries:
                print(f"  {name} {op} p={p} launch: {launch[name]}",
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
