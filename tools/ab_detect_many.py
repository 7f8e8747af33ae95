#!/usr/bin/env python3
"""A/B timing of builds of the multi-candidate detect kernel on one GPU.

    python3 tools/ab_detect_many.py new= old=path/to/detect_many.cu@ \\
        nofma=-DSOME_MACRO=1

Each argument is a build ``name=[source@]flags`` of
``watermarking_gpu_tpu_torch/csrc/detect_many.cu`` (``ab_common.py``).
Every build is called through its C entry point ``wm_detect_many`` on
``chip_smoke.py``'s frames and 64-candidate bank (8 x 1080 x 1920), at ME
and NVF p = 3, 5, 7, 9, on the whole frame; its partial sums are held to
the first build's (largest relative difference printed) and it is timed
with CUDA events, 5 calls after 1, in turns. Prints ptxas' registers,
shared memory and spills per instantiation. Needs a GPU and nvcc; imports
nothing of JAX.
"""

from __future__ import annotations

import sys
import tempfile
from pathlib import Path

import torch

import ab_common as ab


def main() -> int:
    ab.require_card()
    with tempfile.TemporaryDirectory() as tmp:
        libraries = ab.build_variants(sys.argv[1:], ("detect_many.cu",),
                                      ("detect_many_kernel",), Path(tmp))
        frames, bank = ab.frames(), ab.bank()
        coeffs = ab.predictor_coefficients(frames)
        batch, rows, cols = frames.shape
        n = bank.shape[0]

        def run(library, mask: str, p: int, c: torch.Tensor,
                out: torch.Tensor) -> None:
            ab.check_code(library.wm_detect_many(
                frames.data_ptr(), bank.data_ptr(), c.data_ptr(),
                out.data_ptr(), batch, n, rows, cols,
                0 if mask == "me" else 1, p, 0, 0, 0, rows, ab.stream()),
                "wm_detect_many")

        for p in ab.ALL_P:
            for mask in ("me", "nvf"):
                c = coeffs[p if mask == "me" else 3].contiguous()
                outs, sums = {}, {}
                for name, library in libraries.items():
                    chunk = library.wm_detect_many_chunk()
                    outs[name] = torch.empty(
                        (batch, -(-n // chunk),
                         library.wm_detect_many_num_blocks(rows, cols),
                         2 * chunk + 1), device="cuda")
                    run(library, mask, p, c, outs[name])
                    sums[name] = outs[name].sum(dim=2)
                first = next(iter(sums.values()))
                diffs = {name: float(((s - first).abs()
                                      / first.abs().clamp_min(1e-3)).max())
                         for name, s in sums.items()}
                times = ab.in_turns(
                    {name: lambda lib=library, out=outs[name]: run(
                        lib, mask, p, c, out)
                     for name, library in libraries.items()},
                    lambda fn: ab.events_ms(fn, iters=5, warmup=1))
                print(f"{mask} p={p}: " + "; ".join(
                    f"{name} {min(t):.4f}/{max(t):.4f} ms (rel "
                    f"{diffs[name]:.1e})" for name, t in times.items()),
                    flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
