#!/usr/bin/env python3
"""A/B timing of builds of the 3x3 ME Gram on one GPU.

    python3 tools/ab_me_gram.py new= old=path/to/old/me_gram.cu@ \\
        edit=path/to/edited/me_gram.cu@-DNAME=1 --strips 16 24 48 --wide

Each argument is a build ``name=[source@]flags`` of
``watermarking_gpu_tpu_torch/csrc/me_gram.cu`` (``ab_common.py``), ptxas'
registers, shared memory and spills printed per kernel. Each build is the
lag kernel and the assembly kernel, run at each ``--strips`` height
(default ``ops.me.gram_lag_layout``'s). ``--wide`` adds the wide Gram's lag
kernel of ``me_gram_wide.cu`` instantiated at h = 1 (its own p = 3 lags,
alone: it has no assembly at h = 1), at its strip height ``--wide-strip``.

On ``chip_smoke.py``'s frames (8 x 1080 x 1920) every Gram is held to
``me_gram_plain`` (rtol 1e-4, largest relative difference printed) and two
of its calls must give the same bits; the wide lag kernel's sums, added up
per lag, are held to the plain lane partials'. Then each entry is timed in
turns: CUDA events around 20 calls after 3, and each kernel's device time a
call from a ``torch.profiler`` session over 20 calls, with the sum of every
kernel the call launched. Beside them, ``torch.sum`` of the frames, one
library reduction that reads the same bytes, as a yardstick. Needs a GPU
and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
from pathlib import Path

import torch

import ab_common as ab
from watermarking_gpu_tpu_torch.ops import me
from watermarking_gpu_tpu_torch.ops.cuda import build
from watermarking_gpu_tpu_torch.ops.cuda.me_gram_wide import _tables
from watermarking_gpu_tpu_torch.ops.cuda.me_kernel import me_gram_plain

KERNEL_NAMES = ("me_gram_lags_kernel", "me_gram_assemble_kernel",
                "wide_lag_strips_kernel")
# the wide lag kernel's entry point, given its h = 1 instantiation
WIDE_CASE = "    case 2: return WM_STRIPS(2);"
WIDE_CASE_H1 = "    case 1: return WM_STRIPS(1);\n" + WIDE_CASE


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
        ab.check_code(library.wm_me_gram_lags(
            frames.data_ptr(), tables["lag_index"].data_ptr(),
            sums.data_ptr(), batch, rows, cols, strip, me.GRAM_BLOCK_COLS,
            0, 0, None, ab.stream()), "wm_me_gram_lags")
        ab.check_code(library.wm_me_gram_assemble(
            frames.data_ptr(), sums.data_ptr(), tables["lags"].data_ptr(),
            tables["pair_start"].data_ptr(), tables["pairs"].data_ptr(),
            out.data_ptr(), batch, rows, cols, n_strips * n_blocks, 0, 0,
            None, None, None, ab.stream()), "wm_me_gram_assemble")
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
        ab.check_code(library.wm_wide_lag_strips(
            frames.data_ptr(), tables["lag_index"].data_ptr(),
            sums.data_ptr(), edges.data_ptr(), batch, rows, cols, 1, strip,
            me.LANE_BLOCK, 13, 0, 0, rows, ab.stream()), "wm_wide_lag_strips")
    return lags, sums


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--strips", type=int, nargs="+")
    parser.add_argument("--wide", action="store_true",
                        help="add the wide lag kernel at h = 1")
    parser.add_argument("--wide-strip", type=int, default=120)
    parser.add_argument("builds", nargs="*", default=["new="])
    args = parser.parse_args()
    ab.require_card()
    with tempfile.TemporaryDirectory() as tmp:
        builds = list(args.builds)
        if args.wide:
            source = (build.CSRC_DIR / "me_gram_wide.cu").read_text()
            edited = Path(tmp) / "me_gram_wide_h1.cu"
            edited.write_text(source.replace(WIDE_CASE, WIDE_CASE_H1, 1))
            builds.append(f"wide_h1={edited}@")
        libraries = ab.build_variants(builds, ("me_gram.cu",), KERNEL_NAMES,
                                      Path(tmp))
        frames = ab.frames()
        rows, cols = frames.shape[1:]
        want = me_gram_plain(frames)
        entries, errors = {}, {}
        for name, library in libraries.items():
            if hasattr(library, "wm_wide_lag_strips"):
                name = f"{name}/S{args.wide_strip}"
                fn, sums = wide_route(library, frames, args.wide_strip)
                fn()
                first = sums.clone()
                fn()
                if not torch.equal(sums, first):
                    raise SystemExit(f"{name}: two calls differ")
                plain = me.lag_partials_plain(frames, 3).sum(dim=-1)
                errors[name] = ab.rel_err(sums.sum(dim=(2, 3)), plain)
                if errors[name] > ab.SUM_RTOL:
                    raise SystemExit(f"{name}: lag sums rel err "
                                     f"{errors[name]:.3e}")
                entries[name] = fn
                continue
            for strip in args.strips or [me.gram_lag_layout(rows, cols)[0]]:
                label = f"{name}/S{strip}"
                fn = lag_route(library, frames, strip)
                gram = fn().clone()
                errors[label] = ab.rel_err(gram, want)
                if errors[label] > ab.SUM_RTOL:
                    raise SystemExit(f"{label}: Gram rel err "
                                     f"{errors[label]:.3e}")
                if not torch.equal(fn(), gram):
                    raise SystemExit(f"{label}: two calls differ")
                entries[label] = fn
        # a yardstick: one library reduction reading the same bytes
        entries["torch.sum"] = lambda: frames.sum(dim=(1, 2))
        events = ab.in_turns(entries)
        # the profiler after every CUDA-event timing; under it the assembly
        # kernel runs after the lag kernel ends (without it, a programmatic
        # dependent launch overlaps the lag kernel's last wave): CUDA events
        # time the pair as it runs
        device = ab.in_turns(entries, lambda fn: {
            kernel: ms for kernel, (ms, _) in ab.profiled_ms(
                fn, KERNEL_NAMES).items()})
        for name in entries:
            for run in device[name]:
                run["all"] = sum(run.values())
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
