#!/usr/bin/env python3
"""A/B timing of the wide solve kernel (``spd_solve_wide_kernel<k>``, k =
24, 48, 80) on one GPU: builds of
``watermarking_gpu_tpu_torch/csrc/spd_solve.cu`` against each other.

    python3 tools/ab_wide_solve.py [name=[source@]flags ...]

Each argument is a build ``name=[source@]flags`` of ``spd_solve.cu``
(``ab_common.py``; on a copy of the checkout without git history, put the
parent's source in a file and name it). With no arguments the builds are
``parent=git:HEAD@ new=``. ptxas' registers, shared memory and spills are
printed per kernel.

Inputs at p = 5, 7, 9: the wide Grams of ``chip_smoke.py``'s frames (8 x
1080 x 1920, from the package's Gram kernels) and random SPD systems of a
frame Gram's conditioning (``chip_smoke.random_spd_grams``, ridge 1e5, the
seeds of its phase 2) at B = 1, 8 and 300. For each input and build: ms a
call, CUDA events around 20 calls after 3, in turns (min/max printed); the
largest difference from the plain blocked solve (``ops.me.
solve_coefficients_spd_blocked``, TF32 off) and each one's error against a
float64 ``torch.linalg.solve`` of the same systems; whether the valid flags
equal the plain version's; and whether the coefficients are bit-identical
to the first build's. Needs a GPU and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import sys
import tempfile
from pathlib import Path

import torch

import ab_common as ab
from watermarking_gpu_tpu_torch.ops import cuda as kernels

KERNEL_NAMES = ("spd_solve_wide_kernel", "spd_solve8_kernel")
WIDE_P = (5, 7, 9)
BATCHES = (1, 8, 300)       # 300: more blocks than the card has SMs


def solver(library, gram: torch.Tensor):
    """A call of ``library``'s wide solve on ``gram`` into outputs held
    between calls; returns (call, coefficients, valid)."""
    batch, k = gram.shape[0], gram.shape[-1] - 1
    coefficients = torch.empty((batch, k), device=gram.device)
    valid = torch.empty(batch, dtype=torch.bool, device=gram.device)

    def call():
        ab.check_code(library.wm_spd_solve_wide(
            gram.data_ptr(), coefficients.data_ptr(), valid.data_ptr(),
            batch, k, ab.stream()), "wm_spd_solve_wide")
    return call, coefficients, valid


def inputs(p: int) -> dict[str, torch.Tensor]:
    k = p * p - 1
    frames = ab.frames()
    grams = {f"frames B={frames.shape[0]}": kernels.me_gram_wide(frames, p)}
    for batch in BATCHES:
        grams[f"random B={batch}"] = ab.random_spd_grams(
            batch, batch + p, k, ridge=1e5)
    return grams


def main() -> int:
    ab.require_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    with tempfile.TemporaryDirectory() as tmp:
        libraries = ab.build_variants(
            sys.argv[1:] or ["parent=git:HEAD@", "new="], ("spd_solve.cu",),
            KERNEL_NAMES, Path(tmp))
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
                times = ab.in_turns({name: call for name, (call, _, _)
                                     in calls.items()})
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
