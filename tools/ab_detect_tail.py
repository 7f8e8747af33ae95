#!/usr/bin/env python3
"""A/B timing of builds of the detect tail kernel on one GPU.

    python3 tools/ab_detect_tail.py new= old=path/to/fused.cu@ \\
        regs96=-maxrregcount=96

Each argument is a build ``name=[source@]flags`` of
``watermarking_gpu_tpu_torch/csrc/fused.cu`` (``ab_common.py``; it
includes the ``common.cuh`` beside it). Every build is called through its C
entry point ``wm_detect_partials`` (its partials sized by its own
``wm_detect_partials_num_blocks``) on ``chip_smoke.py``'s frames and
watermark (8 x 1080 x 1920), at ME and NVF p = 3, 5, 7, 9, on the whole
frame. Its sums are held to the plain version's (``detect_partials_plain``)
and to the first build's, each dot relative to sqrt(||e_u||^2 ||e_z||^2),
and its two calls must give the same bits. It is timed in turns: CUDA
events around 20 calls after 3, and the kernel's device time a call from a
``torch.profiler`` session over 20 calls, with the launch's registers,
shared memory and blocks per SM from its trace. Prints ptxas' registers,
shared memory and spills per instantiation. Needs a GPU and nvcc; imports
nothing of JAX.
"""

from __future__ import annotations

import sys
import tempfile
from pathlib import Path

import torch

import ab_common as ab
from watermarking_gpu_tpu_torch.ops.cuda.fused import (MASK_CODES,
                                                      detect_partials_plain)

KERNEL = "detect_tail_kernel"


def main() -> int:
    ab.require_card()
    with tempfile.TemporaryDirectory() as tmp:
        libraries = ab.build_variants(sys.argv[1:], ("fused.cu",), (KERNEL,),
                                      Path(tmp))
        frames, wm = ab.frames(), ab.watermark()
        coeffs = ab.predictor_coefficients(frames)
        batch, rows, cols = frames.shape

        def run(library, mask: str, p: int, c: torch.Tensor,
                out: torch.Tensor) -> None:
            ab.check_code(library.wm_detect_partials(
                frames.data_ptr(), wm.data_ptr(), c.data_ptr(),
                out.data_ptr(), batch, rows, cols, MASK_CODES[mask], p, 0, 0,
                0, rows, ab.stream()), "wm_detect_partials")

        cases = [(mask, p) for p in ab.ALL_P for mask in ("me", "nvf")]
        calls, errs, events = {}, {}, {}
        for mask, p in cases:
            c = coeffs[p if mask == "me" else 3].contiguous()
            want = detect_partials_plain(frames, wm, c, mask, p)
            sums = {}
            for name, library in libraries.items():
                blocks = library.wm_detect_partials_num_blocks(rows, cols)
                out = torch.empty((batch, blocks, 3), device="cuda")
                calls[(name, mask, p)] = (
                    lambda lib=library, c=c, out=out, m=mask, p=p:
                    run(lib, m, p, c, out))
                run(library, mask, p, c, out)
                sums[name] = tuple(out.sum(dim=1).unbind(1))
                again = out.clone()
                run(library, mask, p, c, out)
                if not torch.equal(again, out):
                    raise SystemExit(f"{name} {mask} p={p}: two calls differ")
                plain = ab.detect_errors(sums[name], want)[1]
                if plain > ab.SUM_RTOL:
                    raise SystemExit(f"{name} {mask} p={p}: sums rel err "
                                     f"{plain:.3e} against the plain version")
                errs[(name, mask, p)] = (plain, ab.detect_errors(
                    sums[name], next(iter(sums.values())))[1])
            events[(mask, p)] = ab.in_turns(
                {name: calls[(name, mask, p)] for name in libraries})
        # the profiler after every CUDA-event timing
        for mask, p in cases:
            device = ab.in_turns(
                {name: calls[(name, mask, p)] for name in libraries},
                lambda fn: ab.profiled_ms(fn, (KERNEL,))[KERNEL])
            print(f"{mask} p={p}: " + "; ".join(
                f"{name} device {min(ms for ms, _ in device[name]):.4f}/"
                f"{max(ms for ms, _ in device[name]):.4f} ms, events "
                f"{min(events[(mask, p)][name]):.4f}/"
                f"{max(events[(mask, p)][name]):.4f} ms (plain rel "
                f"{errs[(name, mask, p)][0]:.1e}, first rel "
                f"{errs[(name, mask, p)][1]:.1e})" for name in libraries),
                flush=True)
            for name in libraries:
                print(f"  {name} {mask} p={p} launch: {device[name][-1][1]}",
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
