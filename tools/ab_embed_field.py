#!/usr/bin/env python3
"""A/B timing of builds of the embed field kernel on one GPU.

    python3 tools/ab_embed_field.py new= old=path/to/fused.cu@ \\
        tile3=-DWM_EMBED_TILE_P3=1

Each argument is a build ``name=[source@]flags`` of
``watermarking_gpu_tpu_torch/csrc/fused.cu`` (``ab_common.py``; it
includes the ``common.cuh`` beside it). Every build is called through its C
entry point ``wm_embed_field`` (its partials sized by its own
``wm_embed_field_num_blocks``) on ``chip_smoke.py``'s frames and watermark
(8 x 1080 x 1920), at ME and NVF p = 3, 5, 7, 9, on the whole frame. Its
u_raw must equal the plain version's (``embed_field_plain``) and the first
build's bit for bit, its max mask the plain version's exactly and its sum
of u_raw^2 within 1e-4 relative; its two calls must give the same bits. It
is timed in turns: CUDA events around 20 calls after 3, and the kernel's
device time a call from a ``torch.profiler`` session over 20 calls, with
the launch's registers, shared memory and blocks per SM from its trace.
Prints ptxas' registers, shared memory and spills per instantiation. Needs
a GPU and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import sys
import tempfile
from pathlib import Path

import torch

import ab_common as ab
from watermarking_gpu_tpu_torch.ops.cuda.fused import (MASK_CODES,
                                                      embed_field_plain)

KERNEL = "embed_field_kernel"


def main() -> int:
    ab.require_card()
    with tempfile.TemporaryDirectory() as tmp:
        libraries = ab.build_variants(sys.argv[1:], ("fused.cu",), (KERNEL,),
                                      Path(tmp))
        frames, wm = ab.frames(), ab.watermark()
        coeffs = ab.predictor_coefficients(frames)
        batch, rows, cols = frames.shape

        def run(library, mask: str, p: int, u: torch.Tensor,
                out: torch.Tensor) -> None:
            c = coeffs[p].contiguous() if mask == "me" else None
            ab.check_code(library.wm_embed_field(
                frames.data_ptr(), wm.data_ptr(),
                None if c is None else c.data_ptr(), u.data_ptr(),
                out.data_ptr(), batch, rows, cols, MASK_CODES[mask], p, 0, 0,
                ab.stream()), "wm_embed_field")

        cases = [(mask, p) for p in ab.ALL_P for mask in ("me", "nvf")]
        calls, errs, events = {}, {}, {}
        for mask, p in cases:
            want = embed_field_plain(frames, wm, coeffs[p], mask, p)
            first = None
            for name, library in libraries.items():
                blocks = library.wm_embed_field_num_blocks(
                    rows, cols, MASK_CODES[mask], p)
                u = torch.empty_like(frames)
                out = torch.empty((batch, blocks, 2), device="cuda")
                calls[(name, mask, p)] = (
                    lambda lib=library, u=u, out=out, m=mask, p=p:
                    run(lib, m, p, u, out))
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
                errs[(name, mask, p)] = ab.rel_err(out[..., 0].sum(dim=1),
                                                   want[1])
                if errs[(name, mask, p)] > ab.SUM_RTOL:
                    raise SystemExit(f"{name} {mask} p={p}: sum u_raw^2 rel "
                                     f"err {errs[(name, mask, p)]:.3e}")
            del want
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
                f"{max(events[(mask, p)][name]):.4f} ms (u_raw bit-identical,"
                f" sum rel {errs[(name, mask, p)]:.1e})"
                for name in libraries), flush=True)
            for name in libraries:
                print(f"  {name} {mask} p={p} launch: {device[name][-1][1]}",
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
