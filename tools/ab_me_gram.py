#!/usr/bin/env python3
"""A/B timing of builds of the 3x3 ME Gram on one GPU.

    python3 tools/ab_me_gram.py new= old=path/to/old/me_gram.cu@ \\
        edit=path/to/edited/me_gram.cu@-DNAME=1 --strips 16 24 48 --wide

Each argument is ``name=[source@]flags``: a Gram source (default
``watermarking_gpu_tpu_torch/csrc/me_gram.cu``; it includes the
``common.cuh`` of the package) built by its own ``nvcc`` into a shared
library with the extra compiler flags, all builds started together, with
ptxas' registers, shared memory and spills printed per kernel. A build
with the entry point ``wm_me_gram`` is the direct kernel of 45 products a
pixel, finished as its wrapper finished it: a torch sum of the block
partials and the (B, 45) upper triangle scattered into (B, 9, 9). A build
with ``wm_me_gram_lags`` is the lag kernel and the assembly kernel, run at
each ``--strips`` height (default ``ops.me.gram_lag_layout``'s). ``--wide``
adds the wide Gram's lag kernel of ``me_gram_wide.cu`` instantiated at
h = 1 (its own p = 3 lags, alone: it has no assembly at h = 1), at its
strip height ``--wide-strip``.

On ``chip_smoke.py``'s frames (8 x 1080 x 1920) every Gram is held to
``me_gram_plain`` (rtol 1e-4, largest relative difference printed) and two
of its calls must give the same bits; the wide lag kernel's sums, added up
per lag, are held to the plain lane partials'. Then each entry is timed in
turns (every entry in order, then in reverse), so that entries compare
within one call on one card: CUDA events around 20 calls after 3, and each
kernel's device time a call from a ``torch.profiler`` session over 20
calls, with the sum of every kernel the call launched. Beside them,
``torch.sum`` of the frames, one library reduction that reads the same
bytes, as a yardstick. Needs a GPU and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from watermarking_gpu_tpu_torch.ops import me  # noqa: E402
from watermarking_gpu_tpu_torch.ops.cuda import build  # noqa: E402
from watermarking_gpu_tpu_torch.ops.cuda.me_gram_wide import \
    _tables  # noqa: E402
from watermarking_gpu_tpu_torch.ops.cuda.me_kernel import \
    me_gram_plain  # noqa: E402

_PTR, _INT = ctypes.c_void_p, ctypes.c_int
KERNEL_NAMES = ("me_gram_lags_kernel", "me_gram_assemble_kernel",
                "me_gram_kernel", "wide_lag_strips_kernel")
ENTRIES = {"wm_me_gram": (_PTR, _PTR, _INT, _INT, _INT, _PTR),
           "wm_me_gram_num_blocks": (_INT, _INT),
           "wm_me_gram_lags": build.SIGNATURES["wm_me_gram_lags"],
           "wm_me_gram_assemble": build.SIGNATURES["wm_me_gram_assemble"],
           "wm_wide_lag_strips": build.SIGNATURES["wm_wide_lag_strips"]}
# the wide lag kernel's entry point, given its h = 1 instantiation
WIDE_CASE = "    case 2: return WM_STRIPS(2);"
WIDE_CASE_H1 = "    case 1: return WM_STRIPS(1);\n" + WIDE_CASE


def build_all(specs: dict[str, str], out: Path) -> dict[str, ctypes.CDLL]:
    """Build each ``name=[source@]flags`` spec into its own library, all
    ``nvcc`` processes started together."""
    nvcc = build.find_nvcc()
    processes = {}
    for name, spec in specs.items():
        source = str(build.CSRC_DIR / "me_gram.cu")
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
                print(f"{name} {kernel}: {' / '.join(report)}", flush=True)
        library = ctypes.CDLL(str(out / f"{name}.so"))
        for entry, argtypes in ENTRIES.items():
            if hasattr(library, entry):
                getattr(library, entry).argtypes = argtypes
        libraries[name] = library
    return libraries


def check(code: int, name: str) -> None:
    if code:
        raise RuntimeError(f"{name}: CUDA error {code}")


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def direct_route(library, frames: torch.Tensor):
    """The direct kernel's Gram call, finished as its wrapper finished it."""
    batch, rows, cols = frames.shape
    partials = torch.empty((batch, library.wm_me_gram_num_blocks(rows, cols),
                            45), device="cuda")

    def gram():
        check(library.wm_me_gram(frames.data_ptr(), partials.data_ptr(),
                                 batch, rows, cols, stream()), "wm_me_gram")
        upper = partials.sum(dim=1)
        index = torch.triu_indices(9, 9, device=upper.device)
        out = upper.new_empty(batch, 9, 9)
        out[:, index[0], index[1]] = upper
        out[:, index[1], index[0]] = upper
        return out
    return gram


def lag_route(library, frames: torch.Tensor, strip: int):
    """The lag and assembly kernels' Gram call at a strip height, with its
    outputs held between calls."""
    batch, rows, cols = frames.shape
    tables = _tables(3, frames.device)
    n_strips = -(-rows // strip)
    n_blocks = me.gram_lag_layout(rows, cols)[2]
    sums = torch.empty((batch, 13, n_strips, n_blocks), device="cuda")
    out = torch.empty((batch, 9, 9), device="cuda")

    def gram():
        check(library.wm_me_gram_lags(
            frames.data_ptr(), tables["lag_index"].data_ptr(),
            sums.data_ptr(), batch, rows, cols, strip, me.GRAM_BLOCK_COLS,
            0, 0, None, stream()), "wm_me_gram_lags")
        check(library.wm_me_gram_assemble(
            frames.data_ptr(), sums.data_ptr(), tables["lags"].data_ptr(),
            tables["pair_start"].data_ptr(), tables["pairs"].data_ptr(),
            out.data_ptr(), batch, rows, cols, n_strips * n_blocks, 0, 0,
            None, None, None, stream()), "wm_me_gram_assemble")
        return out
    return gram


def wide_route(library, frames: torch.Tensor, strip: int):
    """The wide lag kernel at h = 1 alone; returns (call, its sums)."""
    batch, rows, cols = frames.shape
    tables = _tables(3, frames.device)
    n_strips = -(-rows // strip)
    n_blocks = -(-(cols + 2) // me.LANE_BLOCK)
    sums = torch.empty((batch, 13, n_strips, n_blocks), device="cuda")
    edges = torch.empty((batch, 13, n_strips, 4), device="cuda")

    def lags():
        check(library.wm_wide_lag_strips(
            frames.data_ptr(), tables["lag_index"].data_ptr(),
            sums.data_ptr(), edges.data_ptr(), batch, rows, cols, 1, strip,
            me.LANE_BLOCK, 13, 0, 0, rows, stream()), "wm_wide_lag_strips")
    return lags, sums


def device_ms(fn, calls: int = 20, tries: int = 3) -> dict[str, float]:
    """Device ms a call of each kernel ``fn`` launches (once a call each),
    by kernel name, and of them all ("all"), from one torch.profiler
    session; a mean is over the records the profiler kept. Under the
    profiler the assembly kernel runs after the lag kernel ends (without
    it, a programmatic dependent launch overlaps the lag kernel's last
    wave): CUDA events time the pair as it runs."""
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        total, seen = {}, {}
        for event in prof.events():
            if event.device_type != torch.autograd.DeviceType.CUDA:
                continue
            name = next((k for k in KERNEL_NAMES if k in event.name),
                        event.name[:40])
            total[name] = total.get(name, 0.0) + event.device_time_total / 1e3
            seen[name] = seen.get(name, 0) + 1
        if total:
            means = {name: total[name] / seen[name] for name in total}
            return {**means, "all": sum(means.values())}
    raise SystemExit(f"the profiler kept no kernel record in {tries} "
                     f"sessions")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--strips", type=int, nargs="+")
    parser.add_argument("--wide", action="store_true",
                        help="add the wide lag kernel at h = 1")
    parser.add_argument("--wide-strip", type=int, default=120)
    parser.add_argument("builds", nargs="*", default=["new="])
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("needs a GPU: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    specs = dict(arg.split("=", 1) for arg in args.builds)
    with tempfile.TemporaryDirectory() as tmp:
        if args.wide:
            source = (build.CSRC_DIR / "me_gram_wide.cu").read_text()
            edited = Path(tmp) / "me_gram_wide_h1.cu"
            edited.write_text(source.replace(WIDE_CASE, WIDE_CASE_H1, 1))
            specs["wide_h1"] = f"{edited}@"
        libraries = build_all(specs, Path(tmp))
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"],
                             capture_output=True, text=True)
        print(smi.stdout.strip(), flush=True)
        frames = torch.from_numpy(chip_smoke.make_frames()).cuda()
        rows, cols = frames.shape[1:]
        want = me_gram_plain(frames)
        entries, errors = {}, {}
        for name, library in libraries.items():
            if hasattr(library, "wm_wide_lag_strips"):
                fn, sums = wide_route(library, frames, args.wide_strip)
                fn()
                first = sums.clone()
                fn()
                if not torch.equal(sums, first):
                    raise SystemExit(f"{name}: two calls differ")
                plain = me.lag_partials_plain(frames, 3).sum(dim=-1)
                errors[name] = chip_smoke.rel_err(sums.sum(dim=(2, 3)), plain)
                if errors[name] > chip_smoke.SUM_RTOL:
                    raise SystemExit(f"{name}: lag sums rel err "
                                     f"{errors[name]:.3e}")
                errors[f"{name}/S{args.wide_strip}"] = errors.pop(name)
                entries[f"{name}/S{args.wide_strip}"] = fn
                continue
            routes = ({"": direct_route(library, frames)}
                      if hasattr(library, "wm_me_gram") else
                      {f"/S{s}": lag_route(library, frames, s) for s in
                       args.strips or [me.gram_lag_layout(rows, cols)[0]]})
            for suffix, fn in routes.items():
                gram = fn().clone()
                errors[name + suffix] = chip_smoke.rel_err(gram, want)
                if errors[name + suffix] > chip_smoke.SUM_RTOL:
                    raise SystemExit(f"{name}{suffix}: Gram rel err "
                                     f"{errors[name + suffix]:.3e}")
                if not torch.equal(fn(), gram):
                    raise SystemExit(f"{name}{suffix}: two calls differ")
                entries[name + suffix] = fn
        # a yardstick: one library reduction reading the same bytes
        entries["torch.sum"] = lambda: frames.sum(dim=(1, 2))
        events = {name: [] for name in entries}
        for name in [*entries, *reversed(entries)]:
            events[name].append(chip_smoke.cuda_ms(entries[name]))
        # the profiler after every CUDA-event timing (it may slow launches)
        device = {name: [] for name in entries}
        for name in [*entries, *reversed(entries)]:
            device[name].append(device_ms(entries[name]))
        for name in entries:
            kernels = sorted({k for run in device[name] for k in run})
            print(f"{name}: events {min(events[name]):.4f}/"
                  f"{max(events[name]):.4f} ms; device " + ", ".join(
                      f"{k} {min(r[k] for r in device[name] if k in r):.4f}/"
                      f"{max(r[k] for r in device[name] if k in r):.4f}"
                      for k in kernels) + " ms" + (
                      f" (rel err {errors[name]:.1e}, two calls "
                      f"bit-identical)" if name in errors else ""),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
