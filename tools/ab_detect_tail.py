#!/usr/bin/env python3
"""A/B timing of builds of the detect tail kernel on one GPU.

    python3 tools/ab_detect_tail.py new= old=path/to/fused.cu@ \\
        regs96=-maxrregcount=96 [--unchecked=floor,...]

Each argument is a build ``name=[source@]flags`` of
``watermarking_gpu_tpu_torch/csrc/fused.cu`` (``ab_common.py``; it
includes the ``common.cuh`` beside it). Every build is called through its C
entry point ``wm_detect_partials`` (its partials sized by its own
``wm_detect_partials_num_blocks``, which takes (rows, cols, mask type, p);
an older source's takes (rows, cols) and leaves the rest) on
``chip_smoke.py``'s frames and watermark (8 x 1080 x 1920) at ME and NVF
p = 3, 5, 7, 9, and on the 4K bulk cell's shape, 8 x 2160 x 3840 (those
frames tiled 2 x 2, the engines' 2160 x 3840 watermark), at p = 3, on the
whole frame. Its sums are held to the plain version's
(``detect_partials_plain``) and to the first build's, each dot relative to
sqrt(||e_u||^2 ||e_z||^2), and its two calls must give the same bits; a
build named in ``--unchecked`` (one whose arithmetic is knocked out, to
time what is left) is timed and its errors printed, not held. It is
timed in turns: CUDA events around 20 calls after 3, and the kernel's
device time a call from a ``torch.profiler`` session over 20 calls, with
the launch's registers, shared memory, blocks per SM and grid from its
trace. Prints ptxas' registers, shared memory and spills per
instantiation. Needs a GPU and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import sys
import tempfile
from pathlib import Path

import torch

import ab_common as ab
from watermarking_gpu_tpu_torch.io.matfile import generate_watermark
from watermarking_gpu_tpu_torch.ops.cuda import me_gram_plain
from watermarking_gpu_tpu_torch.ops.cuda.fused import (MASK_CODES,
                                                      detect_partials_plain)
from watermarking_gpu_tpu_torch.ops.me import solve_coefficients_spd

# the one-shot kernel of the wider windows and the pipelined one of the
# 3x3 predictor; a profiler record is keyed by what their names share
KERNELS = ("detect_tail_kernel", "detect_tail_pipelined_kernel")
RECORD = "detect_tail"


def coefficients_p3(frames: torch.Tensor) -> torch.Tensor:
    """The frames' 3x3 predictor from the plain Gram and solve."""
    gram = me_gram_plain(frames)
    coeffs, valid = solve_coefficients_spd(gram[:, :8, :8], gram[:, :8, 8])
    if not bool(valid.all()):
        raise SystemExit("the 3x3 solve flagged a frame")
    return coeffs.contiguous()


def main() -> int:
    ab.require_card()
    args = [a for a in sys.argv[1:] if not a.startswith("--unchecked=")]
    unchecked = {name for a in sys.argv[1:] if a.startswith("--unchecked=")
                 for name in a.split("=", 1)[1].split(",")}
    with tempfile.TemporaryDirectory() as tmp:
        libraries = ab.build_variants(args, ("fused.cu",), KERNELS,
                                      Path(tmp))
        frames, wm = ab.frames(), ab.watermark()
        coeffs = ab.predictor_coefficients(frames)
        frames_4k = frames.repeat(1, 2, 2).contiguous()
        wm_4k = torch.from_numpy(generate_watermark(
            2 * ab.ROWS, 2 * ab.COLS, ab.SEED)).cuda()
        coeffs_4k = coefficients_p3(frames_4k)
        # (label, frames, watermark, mask, p, coefficients)
        cases = [("1080p", frames, wm, mask, p,
                  coeffs[p if mask == "me" else 3].contiguous())
                 for p in ab.ALL_P for mask in ("me", "nvf")]
        cases += [("2160p", frames_4k, wm_4k, mask, 3, coeffs_4k)
                  for mask in ("me", "nvf")]

        def run(library, img: torch.Tensor, w: torch.Tensor, mask: str,
                p: int, c: torch.Tensor, out: torch.Tensor) -> None:
            batch, rows, cols = img.shape
            ab.check_code(library.wm_detect_partials(
                img.data_ptr(), w.data_ptr(), c.data_ptr(), out.data_ptr(),
                batch, rows, cols, MASK_CODES[mask], p, 0, 0, 0, rows,
                ab.stream()), "wm_detect_partials")

        calls, errs, events = {}, {}, {}
        for case in cases:
            label, img, w, mask, p, c = case
            key = (label, mask, p)
            batch, rows, cols = img.shape
            want = detect_partials_plain(img, w, c, mask, p)
            sums = {}
            for name, library in libraries.items():
                blocks = library.wm_detect_partials_num_blocks(
                    rows, cols, MASK_CODES[mask], p)
                out = torch.empty((batch, blocks, 3), device="cuda")
                calls[(name, *key)] = (
                    lambda lib=library, args=(img, w, mask, p, c, out):
                    run(lib, *args))
                calls[(name, *key)]()
                sums[name] = tuple(out.sum(dim=1).unbind(1))
                again = out.clone()
                calls[(name, *key)]()
                plain = ab.detect_errors(sums[name], want)[1]
                if name not in unchecked:
                    if not torch.equal(again, out):
                        raise SystemExit(f"{name} {label} {mask} p={p}: two "
                                         f"calls differ")
                    if plain > ab.SUM_RTOL:
                        raise SystemExit(
                            f"{name} {label} {mask} p={p}: sums rel err "
                            f"{plain:.3e} against the plain version")
                errs[(name, *key)] = (plain, ab.detect_errors(
                    sums[name], next(iter(sums.values())))[1])
            events[key] = ab.in_turns(
                {name: calls[(name, *key)] for name in libraries})
        # the profiler after every CUDA-event timing
        for label, _, _, mask, p, _ in cases:
            key = (label, mask, p)
            device = ab.in_turns(
                {name: calls[(name, *key)] for name in libraries},
                lambda fn: ab.profiled_ms(fn, (RECORD,))[RECORD])
            print(f"{label} {mask} p={p}: " + "; ".join(
                f"{name} device {min(ms for ms, _ in device[name]):.4f}/"
                f"{max(ms for ms, _ in device[name]):.4f} ms, events "
                f"{min(events[key][name]):.4f}/"
                f"{max(events[key][name]):.4f} ms (plain rel "
                f"{errs[(name, *key)][0]:.1e}, first rel "
                f"{errs[(name, *key)][1]:.1e})" for name in libraries),
                flush=True)
            for name in libraries:
                print(f"  {name} {label} {mask} p={p} launch: "
                      f"{device[name][-1][1]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
