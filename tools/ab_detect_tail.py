#!/usr/bin/env python3
"""A/B timing of builds of the detect tail kernel on one GPU.

    python3 tools/ab_detect_tail.py new= old=path/to/fused.cu@ \\
        regs96=-maxrregcount=96

Each argument is ``name=[source@]flags``: the kernel source (default
``watermarking_gpu_tpu_torch/csrc/fused.cu``; it includes the
``common.cuh`` beside it) built by its own ``nvcc`` into a shared library
with the extra compiler flags, all builds started together. Every build is
called through its C entry point ``wm_detect_partials`` (its partials sized
by its own ``wm_detect_partials_num_blocks``) on ``chip_smoke.py``'s frames
and watermark (8 x 1080 x 1920), at ME and NVF p = 3, 5, 7, 9. Its sums are
held to the plain version's (``detect_partials_plain``) and to the first
build's, each dot relative to sqrt(||e_u||^2 ||e_z||^2), and its two calls
must give the same bits. It is timed in turns (every build in order, then
in reverse), so that builds compare within one call on one card: CUDA
events around 20 calls after 3, and the kernel's device time a call from
a ``torch.profiler`` session over 20 calls, in the same turns, with the
launch's registers, shared memory and blocks per SM from its trace. Prints
ptxas' registers, shared memory and spills per instantiation. A source
whose ``wm_detect_partials`` predates the halo form (no ``top``,
``bottom``, ``row_start`` and ``total_rows`` arguments) is called without
them; the others with no halo, the whole frame. Needs a GPU and nvcc;
imports nothing of JAX.
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

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from watermarking_gpu_tpu_torch.io.matfile import \
    generate_watermark  # noqa: E402
from watermarking_gpu_tpu_torch.ops.cuda import build  # noqa: E402
from watermarking_gpu_tpu_torch.ops.cuda.fused import (  # noqa: E402
    MASK_CODES, detect_partials_plain)

KERNEL = "detect_tail_kernel"


def build_variants(specs: dict[str, str], out: Path) -> dict[str, ctypes.CDLL]:
    nvcc = build.find_nvcc()
    processes, texts = {}, {}
    for name, spec in specs.items():
        source = str(build.CSRC_DIR / "fused.cu")
        if "@" in spec:
            source, spec = spec.split("@", 1)
        command = [nvcc, *build.NVCC_FLAGS, "-shared", *spec.split(), "-o",
                   str(out / f"{name}.so"), source]
        texts[name] = Path(source).read_text()
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
            if "Compiling entry" in line and KERNEL in line:
                report = [x.split(":")[-1].strip() for x in lines[i + 1:i + 4]
                          if "Used" in x or "spill" in x]
                template = line.split(KERNEL)[1][:16]
                print(f"{name} {template}: {' / '.join(report)}", flush=True)
        library = ctypes.CDLL(str(out / f"{name}.so"))
        library.halo_form = bool(re.search(
            r"int wm_detect_partials\([^)]*\btotal_rows\b", texts[name]))
        library.wm_detect_partials.argtypes = (
            *[ctypes.c_void_p] * 4,
            *[ctypes.c_int] * (9 if library.halo_form else 5),
            ctypes.c_void_p)
        library.wm_detect_partials_num_blocks.argtypes = (ctypes.c_int,
                                                          ctypes.c_int)
        libraries[name] = library
    return libraries


def device_run(fn, out: Path, calls: int = 20,
               tries: int = 3) -> tuple[float, str]:
    """The kernel's device ms a call over ``calls`` calls of ``fn`` in one
    torch.profiler session, and its launch's registers, shared memory and
    blocks per SM, from the session's trace. The profiler may drop records,
    so the mean is over the records it kept, and a session that kept none
    is run again."""
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
            and KERNEL in event.get("name", "")]
        if records:
            args = records[0].get("args", {})
            return (sum(event["dur"] for event in records) / 1e3
                    / len(records),
                    ", ".join(f"{key} {args[key]}" for key in (
                        "registers per thread", "shared memory",
                        "blocks per SM") if key in args))
    raise SystemExit(f"the profiler kept no {KERNEL} record in {tries} "
                     f"sessions")


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
        wm = torch.from_numpy(generate_watermark(
            chip_smoke.ROWS, chip_smoke.COLS, chip_smoke.SEED).astype(
                np.float32)).cuda()
        coeffs = chip_smoke.predictor_coefficients(frames)
        batch, rows, cols = frames.shape

        def run(library, mask: str, p: int, c: torch.Tensor,
                out: torch.Tensor) -> None:
            code = library.wm_detect_partials(
                frames.data_ptr(), wm.data_ptr(), c.data_ptr(),
                out.data_ptr(), batch, rows, cols,
                MASK_CODES[mask], p,
                *((0, 0, 0, rows) if library.halo_form else ()),
                torch.cuda.current_stream().cuda_stream)
            if code:
                raise RuntimeError(f"wm_detect_partials: CUDA error {code}")

        cases = [(mask, p) for p in chip_smoke.ALL_P for mask in ("me", "nvf")]
        outs, errs, events = {}, {}, {}
        for mask, p in cases:
            c = coeffs[p if mask == "me" else 3].contiguous()
            want = detect_partials_plain(frames, wm, c, mask, p)
            sums = {}
            for name, library in libraries.items():
                blocks = library.wm_detect_partials_num_blocks(rows, cols)
                out = torch.empty((batch, blocks, 3), device="cuda")
                outs[(name, mask, p)] = out
                run(library, mask, p, c, out)
                sums[name] = tuple(out.sum(dim=1).unbind(1))
                again = out.clone()
                run(library, mask, p, c, out)
                if not torch.equal(again, out):
                    raise SystemExit(f"{name} {mask} p={p}: two calls differ")
                plain = chip_smoke.detect_errors(sums[name], want)[1]
                if plain > chip_smoke.SUM_RTOL:
                    raise SystemExit(f"{name} {mask} p={p}: sums rel err "
                                     f"{plain:.3e} against the plain version")
                errs[(name, mask, p)] = (plain, chip_smoke.detect_errors(
                    sums[name], next(iter(sums.values())))[1])
            for name in [*libraries, *reversed(libraries)]:
                events.setdefault((name, mask, p), []).append(
                    chip_smoke.cuda_ms(lambda: run(
                        libraries[name], mask, p, c, outs[(name, mask, p)])))
        # the profiler after every CUDA-event timing (it may slow launches)
        for mask, p in cases:
            c = coeffs[p if mask == "me" else 3].contiguous()
            device, launch = {}, {}
            for name in [*libraries, *reversed(libraries)]:
                ms, launch[name] = device_run(
                    lambda n=name: run(libraries[n], mask, p, c,
                                       outs[(n, mask, p)]), Path(tmp))
                device.setdefault(name, []).append(ms)
            print(f"{mask} p={p}: " + "; ".join(
                f"{name} device {min(device[name]):.4f}/"
                f"{max(device[name]):.4f} ms, events "
                f"{min(events[(name, mask, p)]):.4f}/"
                f"{max(events[(name, mask, p)]):.4f} ms (plain rel "
                f"{errs[(name, mask, p)][0]:.1e}, first rel "
                f"{errs[(name, mask, p)][1]:.1e})" for name in libraries),
                flush=True)
            for name in libraries:
                print(f"  {name} {mask} p={p} launch: {launch[name]}",
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
