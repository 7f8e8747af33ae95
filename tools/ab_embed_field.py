#!/usr/bin/env python3
"""A/B timing of builds of the embed field kernel on one GPU.

    python3 tools/ab_embed_field.py new= old=path/to/fused.cu@ \\
        tile3=-DWM_EMBED_TILE_P3=1

Each argument is ``name=[source@]flags``: the kernel source (default
``watermarking_gpu_tpu_torch/csrc/fused.cu``; it includes the
``common.cuh`` beside it) built by its own ``nvcc`` into a shared library
with the extra compiler flags, all builds started together. Every build is
called through its C entry point ``wm_embed_field`` (its partials sized by
its own ``wm_embed_field_num_blocks``) on ``chip_smoke.py``'s frames and
watermark (8 x 1080 x 1920), at ME and NVF p = 3, 5, 7, 9. Its u_raw must
equal the plain version's (``embed_field_plain``) and the first build's bit
for bit, its max mask the plain version's exactly and its sum of u_raw^2
within 1e-4 relative; its two calls must give the same bits. It is timed in
turns (every build in order, then in reverse), so that builds compare
within one call on one card: CUDA events around 20 calls after 3, and the
kernel's device time a call from a ``torch.profiler`` session over 20
calls, in the same turns, with the launch's registers, shared memory and
blocks per SM from its trace. Prints ptxas' registers, shared memory and
spills per instantiation. A source whose ``wm_embed_field`` predates the
halo form (no ``top`` and ``bottom`` arguments) is called without them;
the others with no halo, the whole frame. Needs a GPU and nvcc; imports
nothing of JAX.
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
    MASK_CODES, embed_field_plain)

KERNEL = "embed_field"   # every embed field kernel a build may have
ENTRIES = ("wm_embed_field", "wm_embed_field_num_blocks")


def instantiation(mangled: str) -> str:
    """The name and template arguments, as "embed_field_kernel<0, 2>", of
    the kernel in a mangled symbol whose name starts with KERNEL."""
    for match in re.finditer(r"\d+(?=" + KERNEL + ")", mangled):
        digits = match.group()
        for k in reversed(range(len(digits))):   # the length's own digits
            n = int(digits[k:])
            rest = mangled[match.end() + n:]
            if rest[:1] in ("I", "E"):
                name = mangled[match.end():match.end() + n]
                args = re.match(r"I((?:Li-?\d+E)+)E", rest)
                if args:
                    name += "<" + ", ".join(
                        re.findall(r"Li(-?\d+)E", args.group(1))) + ">"
                return name
    return mangled


def build_variants(specs: dict[str, str], out: Path) -> dict[str, ctypes.CDLL]:
    """Build each ``name=[source@]flags`` spec into its own library, all
    ``nvcc`` processes started together, and print ptxas' registers, shared
    memory and spills of each embed field instantiation."""
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
                symbol = instantiation(line.split("'")[1])
                print(f"{name} {symbol}: {' / '.join(report)}", flush=True)
        library = ctypes.CDLL(str(out / f"{name}.so"))
        for entry in ENTRIES:
            getattr(library, entry).argtypes = build.SIGNATURES[entry]
        library.halo_form = bool(re.search(
            r"int wm_embed_field\([^)]*\bbottom\b", texts[name]))
        if not library.halo_form:   # (..., mask_type, p, stream)
            signature = build.SIGNATURES["wm_embed_field"]
            library.wm_embed_field.argtypes = (*signature[:-3],
                                               signature[-1])
        libraries[name] = library
    return libraries


def device_run(fn, out: Path, calls: int = 20,
               tries: int = 3) -> tuple[float, str]:
    """The embed field's device ms a call over ``calls`` calls of ``fn`` in
    one torch.profiler session, and its launch's registers, shared memory
    and blocks per SM, from the session's trace. The profiler may drop
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

        def run(library, mask: str, p: int, u: torch.Tensor,
                out: torch.Tensor) -> None:
            c = coeffs[p].contiguous() if mask == "me" else None
            code = library.wm_embed_field(
                frames.data_ptr(), wm.data_ptr(),
                None if c is None else c.data_ptr(), u.data_ptr(),
                out.data_ptr(), batch, rows, cols, MASK_CODES[mask], p,
                *((0, 0) if library.halo_form else ()),
                torch.cuda.current_stream().cuda_stream)
            if code:
                raise RuntimeError(f"wm_embed_field: CUDA error {code}")

        cases = [(mask, p) for p in chip_smoke.ALL_P for mask in ("me", "nvf")]
        outs, errs, events = {}, {}, {}
        for mask, p in cases:
            want = embed_field_plain(frames, wm, coeffs[p], mask, p)
            first = None
            for name, library in libraries.items():
                blocks = library.wm_embed_field_num_blocks(
                    rows, cols, MASK_CODES[mask], p)
                u = torch.empty_like(frames)
                out = torch.empty((batch, blocks, 2), device="cuda")
                outs[(name, mask, p)] = (u, out)
                run(library, mask, p, u, out)
                u_again, out_again = u.clone(), out.clone()
                run(library, mask, p, u, out)
                if not (torch.equal(u_again, u)
                        and torch.equal(out_again, out)):
                    raise SystemExit(f"{name} {mask} p={p}: two calls differ")
                if not torch.equal(u, want[0]):
                    raise SystemExit(
                        f"{name} {mask} p={p}: u_raw not bit-identical to "
                        f"the plain version, max abs err "
                        f"{float((u - want[0]).abs().max()):.3e}")
                if first is not None and not torch.equal(u, first):
                    raise SystemExit(f"{name} {mask} p={p}: u_raw differs "
                                     f"from the first build's")
                first = u if first is None else first
                if not torch.equal(out[..., 1].amax(dim=1), want[2]):
                    raise SystemExit(f"{name} {mask} p={p}: max mask differs "
                                     f"from the plain version's")
                errs[(name, mask, p)] = chip_smoke.rel_err(
                    out[..., 0].sum(dim=1), want[1])
                if errs[(name, mask, p)] > chip_smoke.SUM_RTOL:
                    raise SystemExit(f"{name} {mask} p={p}: sum u_raw^2 rel "
                                     f"err {errs[(name, mask, p)]:.3e}")
            del want
            for name in [*libraries, *reversed(libraries)]:
                events.setdefault((name, mask, p), []).append(
                    chip_smoke.cuda_ms(lambda: run(
                        libraries[name], mask, p, *outs[(name, mask, p)])))
        # the profiler after every CUDA-event timing (it may slow launches)
        for mask, p in cases:
            device, launch = {}, {}
            for name in [*libraries, *reversed(libraries)]:
                ms, launch[name] = device_run(
                    lambda n=name: run(libraries[n], mask, p,
                                       *outs[(n, mask, p)]), Path(tmp))
                device.setdefault(name, []).append(ms)
            print(f"{mask} p={p}: " + "; ".join(
                f"{name} device {min(device[name]):.4f}/"
                f"{max(device[name]):.4f} ms, events "
                f"{min(events[(name, mask, p)]):.4f}/"
                f"{max(events[(name, mask, p)]):.4f} ms (u_raw bit-identical,"
                f" sum rel {errs[(name, mask, p)]:.1e})"
                for name in libraries), flush=True)
            for name in libraries:
                print(f"  {name} {mask} p={p} launch: {launch[name]}",
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
