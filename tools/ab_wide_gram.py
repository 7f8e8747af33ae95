#!/usr/bin/env python3
"""A/B timing of the wide Gram (p = 5, 7, 9) on one GPU: an earlier lag
kernel with the torch assembly against builds of the two kernels of
``watermarking_gpu_tpu_torch/csrc/me_gram_wide.cu``.

    python3 tools/ab_wide_gram.py new= edit=path/to/edited/me_gram_wide.cu@ \\
        --old path/to/old/me_gram_wide.cu --strips 60 120

``--old`` is a source whose entry point ``wm_me_gram_wide`` writes the lag
partials of every (dr, dc) in [0, 2h] x [-2h, 2h] as
(B, 4h+1, 2h+1, W+2h); its Gram is that kernel, a gather of the canonical
lags and ``ops.me.assemble_wide``. Each other argument is
``name=[source@]flags``: a source of the two kernels (default the
package's) built with the extra compiler flags; every build is a shared
library of its own, all ``nvcc`` processes started together, and ptxas'
registers, shared memory and spills are printed per kernel. Each new build
runs at each ``--strips`` height (default ``ops.me.wide_lag_layout``'s).

On ``chip_smoke.py``'s frames (8 x 1080 x 1920): every Gram is held to
``ops.me.me_gram_wide_plain`` (largest relative difference printed), then
timed with CUDA events, 20 calls after 3, in turns (every entry in order,
then in reverse), so that the entries compare within one call on one card;
for each entry also its kernels alone. Needs a GPU and nvcc; imports nothing
of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from watermarking_gpu_tpu_torch.ops import me  # noqa: E402
from watermarking_gpu_tpu_torch.ops.cuda import build  # noqa: E402

wide = importlib.import_module("watermarking_gpu_tpu_torch.ops.cuda."
                               "me_gram_wide")
KERNEL_NAMES = ("wide_lag_strips_kernel", "wide_assemble_kernel",
                "me_gram_wide_kernel")
_PTR, _INT = ctypes.c_void_p, ctypes.c_int


def build_all(specs: dict[str, str], out: Path) -> dict[str, ctypes.CDLL]:
    nvcc = build.find_nvcc()
    processes = {}
    for name, spec in specs.items():
        source = str(build.CSRC_DIR / "me_gram_wide.cu")
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
            kernel = next((k for k in KERNEL_NAMES if k in line), None)
            if "Compiling entry" in line and kernel:
                report = [x.split(":", 1)[-1].strip()
                          for x in lines[i + 1:i + 4]
                          if "Used" in x or "spill" in x]
                template = line.split(kernel)[1][:6]
                print(f"{name} {kernel}{template}: {' / '.join(report)}",
                      flush=True)
        library = ctypes.CDLL(str(out / f"{name}.so"))
        if hasattr(library, "wm_wide_assemble"):
            for entry in ("wm_wide_lag_strips", "wm_wide_assemble"):
                getattr(library, entry).argtypes = build.SIGNATURES[entry]
        else:
            library.wm_me_gram_wide.argtypes = (_PTR, _PTR, *[_INT] * 4,
                                                _PTR)
        libraries[name] = library
    return libraries


def check(code: int, name: str) -> None:
    if code:
        raise RuntimeError(f"{name}: CUDA error {code}")


def old_route(library, frames: torch.Tensor, p: int):
    """(Gram call, lag kernel call) of a source with the old entry point."""
    batch, rows, cols = frames.shape
    h = p // 2
    dense = torch.empty((batch, (4 * h + 1) * (2 * h + 1), cols + 2 * h),
                        device="cuda")
    slots = torch.tensor([(dc + 2 * h) * (2 * h + 1) + dr
                          for dr, dc in me.lag_plan(p)[0]], device="cuda")

    def lags():
        check(library.wm_me_gram_wide(
            frames.data_ptr(), dense.data_ptr(), batch, rows, cols, h,
            torch.cuda.current_stream().cuda_stream), "wm_me_gram_wide")

    def gram():
        lags()
        return me.assemble_wide(dense[:, slots], frames, p)
    return gram, lags


def new_route(library, frames: torch.Tensor, p: int, strip: int):
    """(Gram call, lag kernel call, assembly kernel call) of a build of the
    two kernels, with its outputs held between the calls."""
    batch, rows, cols = frames.shape
    h = p // 2
    tables = wide._tables(p, frames.device)
    n_lags = len(me.lag_plan(p)[0])
    n_strips = -(-rows // strip)
    n_blocks = me.wide_lag_layout(rows, cols, p)[2]
    sums = torch.empty((batch, n_lags, n_strips, n_blocks), device="cuda")
    edges = torch.empty((batch, n_lags, n_strips, 4 * h), device="cuda")
    out = torch.empty((batch, p * p, p * p), device="cuda")

    def lags():
        check(library.wm_wide_lag_strips(
            frames.data_ptr(), tables["lag_index"].data_ptr(),
            sums.data_ptr(), edges.data_ptr(), batch, rows, cols, h, strip,
            me.LANE_BLOCK, n_lags, torch.cuda.current_stream().cuda_stream),
            "wm_wide_lag_strips")

    def assemble():
        check(library.wm_wide_assemble(
            frames.data_ptr(), sums.data_ptr(), edges.data_ptr(),
            tables["lags"].data_ptr(), tables["pair_start"].data_ptr(),
            tables["pairs"].data_ptr(), out.data_ptr(), batch, rows, cols,
            h, n_lags, n_strips, n_blocks,
            torch.cuda.current_stream().cuda_stream), "wm_wide_assemble")

    def gram():
        lags()
        assemble()
        return out
    return gram, lags, assemble


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--old", help="source with wm_me_gram_wide")
    parser.add_argument("--strips", type=int, nargs="+")
    parser.add_argument("--p", type=int, nargs="+", default=[5, 7, 9])
    parser.add_argument("builds", nargs="*", default=["new="])
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("needs a GPU: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    specs = dict(arg.split("=", 1) for arg in args.builds)
    if args.old:
        specs = {"old": f"{args.old}@", **specs}
    with tempfile.TemporaryDirectory() as tmp:
        libraries = build_all(specs, Path(tmp))
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"],
                             capture_output=True, text=True)
        print(smi.stdout.strip(), flush=True)
        frames = torch.from_numpy(chip_smoke.make_frames()).cuda()
        rows, cols = frames.shape[1:]
        for p in args.p:
            want = me.me_gram_wide_plain(frames, p)
            entries = {}   # name -> {"gram": fn, part: fn, ...}
            for name, library in libraries.items():
                if name == "old":
                    gram, lags = old_route(library, frames, p)
                    entries[name] = {"gram": gram, "lags": lags}
                    continue
                for strip in (args.strips
                              or [me.wide_lag_layout(rows, cols, p)[0]]):
                    gram, lags, assemble = new_route(library, frames, p,
                                                     strip)
                    entries[f"{name}/S{strip}"] = {
                        "gram": gram, "lags": lags, "assemble": assemble}
            errors = {name: chip_smoke.rel_err(fns["gram"](), want)
                      for name, fns in entries.items()}
            times = {name: {part: [] for part in fns}
                     for name, fns in entries.items()}
            for name in [*entries, *reversed(entries)]:
                for part, fn in entries[name].items():
                    times[name][part].append(chip_smoke.cuda_ms(fn))
            for name, parts in times.items():
                print(f"p={p} {name}: " + "; ".join(
                    f"{part} {min(t):.4f}/{max(t):.4f} ms"
                    for part, t in parts.items())
                    + f" (Gram rel err {errors[name]:.1e})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
