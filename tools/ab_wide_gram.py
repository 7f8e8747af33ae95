#!/usr/bin/env python3
"""A/B timing of builds of the wide Gram (p = 5, 7, 9) on one GPU.

    python3 tools/ab_wide_gram.py new= edit=path/to/edited/me_gram_wide.cu@ \\
        --strips 60 120

Each argument is a build ``name=[source@]flags`` of the two kernels of
``watermarking_gpu_tpu_torch/csrc/me_gram_wide.cu`` (``ab_common.py``),
ptxas' registers, shared memory and spills printed per kernel. Each build
runs at each ``--strips`` height (default ``ops.me.wide_lag_layout``'s),
on the whole frame, its assembly given the frame's banks
(``ops.me.frame_banks``), gathered in the call as ``me_gram_wide`` does.

On ``chip_smoke.py``'s frames (8 x 1080 x 1920): every Gram is held to
``ops.me.me_gram_wide_plain`` (largest relative difference printed) and
compared bit for bit with the first entry's, then timed with CUDA events,
20 calls after 3, in turns; for each entry also its kernels alone. Needs a
GPU and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
from pathlib import Path

import torch

import ab_common as ab
from watermarking_gpu_tpu_torch.ops import me
from watermarking_gpu_tpu_torch.ops.cuda.me_gram_wide import _tables

KERNEL_NAMES = ("wide_lag_strips_kernel", "wide_assemble_kernel")


def route(library, frames: torch.Tensor, p: int, strip: int):
    """(Gram call, lag kernel call, assembly kernel call) of a build, with
    its outputs held between the calls."""
    batch, rows, cols = frames.shape
    h = p // 2
    tables = _tables(p, frames.device)
    n_lags = len(me.lag_plan(p)[0])
    n_strips = -(-rows // strip)
    n_blocks = me.wide_lag_layout(rows, cols, p)[2]
    sums = torch.empty((batch, n_lags, n_strips, n_blocks), device="cuda")
    edges = torch.empty((batch, n_lags, n_strips, 4 * h), device="cuda")
    out = torch.empty((batch, p * p, p * p), device="cuda")
    banks = me.frame_banks(frames, p)

    def lags():
        ab.check_code(library.wm_wide_lag_strips(
            frames.data_ptr(), tables["lag_index"].data_ptr(),
            sums.data_ptr(), edges.data_ptr(), batch, rows, cols, h, strip,
            me.LANE_BLOCK, n_lags, 0, 0, rows, ab.stream()),
            "wm_wide_lag_strips")

    def assemble(low=banks[0], high=banks[1]):
        ab.check_code(library.wm_wide_assemble(
            low.data_ptr(), high.data_ptr(), low.stride(0), sums.data_ptr(),
            edges.data_ptr(), tables["lags"].data_ptr(),
            tables["pair_start"].data_ptr(), tables["pairs"].data_ptr(),
            out.data_ptr(), batch, cols, h, n_lags, n_strips, n_blocks, rows,
            ab.stream()), "wm_wide_assemble")

    def gram():
        lags()
        assemble(*me.frame_banks(frames, p))
        return out
    return gram, lags, assemble


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--strips", type=int, nargs="+")
    parser.add_argument("--p", type=int, nargs="+", default=[5, 7, 9])
    parser.add_argument("builds", nargs="*", default=["new="])
    args = parser.parse_args()
    ab.require_card()
    with tempfile.TemporaryDirectory() as tmp:
        libraries = ab.build_variants(args.builds, ("me_gram_wide.cu",),
                                      KERNEL_NAMES, Path(tmp))
        frames = ab.frames()
        rows, cols = frames.shape[1:]
        for p in args.p:
            want = me.me_gram_wide_plain(frames, p)
            entries = {}   # name -> {"gram": fn, part: fn, ...}
            for name, library in libraries.items():
                for strip in (args.strips
                              or [me.wide_lag_layout(rows, cols, p)[0]]):
                    entries[f"{name}/S{strip}"] = dict(zip(
                        ("gram", "lags", "assemble"),
                        route(library, frames, p, strip)))
            grams = {name: fns["gram"]().clone()
                     for name, fns in entries.items()}
            first = next(iter(grams.values()))
            times = ab.in_turns(entries, lambda fns: {
                part: ab.events_ms(fn) for part, fn in fns.items()})
            for name, runs in times.items():
                print(f"p={p} {name}: " + "; ".join(
                    f"{part} {min(r[part] for r in runs):.4f}/"
                    f"{max(r[part] for r in runs):.4f} ms"
                    for part in entries[name])
                    + f" (Gram rel err {ab.rel_err(grams[name], want):.1e}; "
                    + ("bit-identical to" if torch.equal(grams[name], first)
                       else "differs from")
                    + f" {next(iter(grams))}'s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
