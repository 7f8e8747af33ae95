#!/usr/bin/env python3
"""A/B timing of builds of the standalone prediction error and NVF mask
kernels (``prediction_error_kernel<PH>``, ``nvf_mask_kernel<NH>``) on one
GPU.

    python3 tools/ab_standalone.py [name=[DIR@]flags ...]

Each argument is a build ``name=[source@]flags`` of ``predict.cu`` and
``nvf.cu`` (``ab_common.py``; DIR a directory holding both, or
``git:REV``: on a copy of the checkout without git history, unpack them
into a directory first). With no arguments the builds are
``parent=git:HEAD@ new=``. Prints ptxas' registers, shared memory and
spills per instantiation.

Every build is called through its C entry points ``wm_prediction_error``
and ``wm_nvf_mask`` on ``chip_smoke.py``'s frames (8 x 1080 x 1920) at p =
3, 5, 7, 9, the prediction error with seeded random coefficients. Its
output must equal the plain version's (``prediction_error_plain``,
``nvf_mask_plain``) and the first build's bit for bit, and its two calls
must give the same bits. It is timed in turns: CUDA events around 20 calls
after 3, then the kernel's device time a call from a ``torch.profiler``
session over 20 calls, with the launch's registers, shared memory and
blocks per SM from its trace. Beside them: the benchmark's bound
(``wmbench/work/kernels.py``) and, for the prediction error, the floor of
its 2(p*p-1) rounded f32 instructions a pixel; once, the time of a
``Tensor.copy_`` of the frames, which moves the same 8 bytes a pixel.
Needs a GPU and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

import ab_common as ab
from watermarking_gpu_tpu_torch.ops.cuda.nvf import nvf_mask_plain
from watermarking_gpu_tpu_torch.ops.cuda.predict import \
    prediction_error_plain
from wmbench.work.kernels import F32_FLOPS_PER_S, kernel_bound

KERNELS = {"prediction_error": "prediction_error_kernel",
           "nvf_mask": "nvf_mask_kernel"}
# f32 instructions a second: 132 SMs x 128 lanes x 1.98 GHz, the rate
# behind the data sheet's 67 TFLOP/s of fused multiply-adds
F32_INSTRUCTIONS_PER_S = F32_FLOPS_PER_S / 2


def main() -> int:
    ab.require_card()
    with tempfile.TemporaryDirectory() as tmp:
        libraries = ab.build_variants(
            sys.argv[1:] or ["parent=git:HEAD@", "new="],
            ("predict.cu", "nvf.cu"), tuple(KERNELS.values()), Path(tmp))
        frames = ab.frames()
        batch, rows, cols = frames.shape

        def run(library, op: str, p: int, coeffs: torch.Tensor,
                out: torch.Tensor) -> None:
            ab.check_code(library.wm_prediction_error(
                frames.data_ptr(), coeffs.data_ptr(), out.data_ptr(), batch,
                rows, cols, p, ab.stream()) if op == "prediction_error" else
                library.wm_nvf_mask(frames.data_ptr(), out.data_ptr(), batch,
                                    rows, cols, p, ab.stream()), op)

        cases = [(op, p) for p in ab.ALL_P for op in KERNELS]
        calls, events = {}, {}
        for op, p in cases:
            coeffs = torch.from_numpy(np.random.default_rng(p).normal(
                0, 0.1, (batch, p * p - 1)).astype(np.float32)).cuda()
            want = (prediction_error_plain(frames, coeffs, p)
                    if op == "prediction_error" else
                    nvf_mask_plain(frames, p))
            for name, library in libraries.items():
                out = torch.empty_like(frames)
                calls[(name, op, p)] = (
                    lambda lib=library, o=op, p=p, c=coeffs, out=out:
                    run(lib, o, p, c, out))
                run(library, op, p, coeffs, out)
                again = out.clone()
                run(library, op, p, coeffs, out)
                if not torch.equal(again, out):
                    raise SystemExit(f"{name} {op} p={p}: two calls differ")
                if not torch.equal(out, want):
                    raise SystemExit(
                        f"{name} {op} p={p}: not bit-identical to the plain "
                        f"version, max abs err "
                        f"{float((out - want).abs().max()):.3e}")
            del want
            events[(op, p)] = ab.in_turns(
                {name: calls[(name, op, p)] for name in libraries})
        # the card's own rate for these bytes: one PyTorch copy of the
        # frames reads and writes what either kernel must, 8 bytes a pixel
        copy = torch.empty_like(frames)
        copy_ms = [ab.events_ms(lambda: copy.copy_(frames)) for _ in range(2)]
        print(f"a copy of the frames (Tensor.copy_, events): "
              f"{min(copy_ms):.4f}/{max(copy_ms):.4f} ms", flush=True)
        pixels = batch * rows * cols
        # the profiler after every CUDA-event timing
        for op, p in cases:
            device = ab.in_turns(
                {name: calls[(name, op, p)] for name in libraries},
                lambda fn: ab.profiled_ms(fn, (KERNELS[op],))[KERNELS[op]])
            bound_ms, bound_by = kernel_bound(op, "me", p)
            floor = ""
            if op == "prediction_error":
                floor_ms = (2 * (p * p - 1) * pixels
                            / F32_INSTRUCTIONS_PER_S * 1e3)
                floor = f", rounded-pair floor {floor_ms:.4f} ms"
            print(f"{op} p={p}: " + "; ".join(
                f"{name} device {min(ms for ms, _ in device[name]):.4f}/"
                f"{max(ms for ms, _ in device[name]):.4f} ms, events "
                f"{min(events[(op, p)][name]):.4f}/"
                f"{max(events[(op, p)][name]):.4f} ms"
                for name in libraries)
                + f" (bit-identical to the plain version); bound "
                f"{bound_ms:.4f} ms ({bound_by}){floor}", flush=True)
            for name in libraries:
                print(f"  {name} {op} p={p} launch: {device[name][-1][1]}",
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
