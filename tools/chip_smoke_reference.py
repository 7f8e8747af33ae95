#!/usr/bin/env python3
"""Compute, with the JAX package on the CPU, the reference numbers that
``chip_smoke.py`` holds the PyTorch port to on the GPU.

    JAX_PLATFORMS=cpu python tools/chip_smoke_reference.py --p 5 7 9 \
        --frames 0 5
    JAX_PLATFORMS=cpu python tools/chip_smoke_reference.py \
        --identify me:3 nvf:3 me:5

For each window size p and mask, frame by frame (``impl="xla"``, the JAX
package's oracle): ``embed_pipeline(frame, frame, W, strength_factor(40),
mask, p)``, then ``detect_pipeline`` on the marked frame ("corr") and on
the clean one ("clean_corr"), and mean |marked - frame| ("mean_abs_delta").
The frames and watermark are the ones ``chip_smoke.make_frames()`` and
``generate_watermark(1080, 1920, 28390211)`` give. Prints one JSON object
keyed by p, in the layout of ``chip_smoke.JAX_WIDE_REFERENCE``.

With ``--identify mask:p ...``: for each case, frame 0 marked as above
("marked") and frame 0 clean ("clean") through ``detect_many_pipeline``
(``impl="xla"``) against ``chip_smoke.make_bank()``'s 64 candidates, 8 at
a time. Prints one JSON object keyed by "mask:p", in the layout of
``chip_smoke.JAX_IDENTIFY_REFERENCE``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import (COLS, PSNR, ROWS, SEED, make_bank,  # noqa: E402
                        make_frames)
from watermarking_gpu_tpu.io.matfile import generate_watermark  # noqa: E402
from watermarking_gpu_tpu.ops.embed import strength_factor  # noqa: E402
from watermarking_gpu_tpu.ops.pipelines import (  # noqa: E402
    detect_many_pipeline, detect_pipeline, embed_pipeline)


def reference(p: int, frame_indices: list[int], frames: np.ndarray,
              watermark: jnp.ndarray) -> dict:
    sf = strength_factor(PSNR)
    out: dict = {}
    for mask in ("me", "nvf"):
        rows = {"strength": [], "corr": [], "clean_corr": [],
                "mean_abs_delta": []}
        for i in frame_indices:
            start = time.perf_counter()
            frame = jnp.asarray(frames[i])
            marked, strength = embed_pipeline(frame, frame, watermark, sf,
                                              mask, p=p, impl="xla")
            rows["strength"].append(float(strength))
            rows["corr"].append(float(detect_pipeline(
                marked, watermark, mask, p=p, impl="xla")))
            rows["clean_corr"].append(float(detect_pipeline(
                frame, watermark, mask, p=p, impl="xla")))
            rows["mean_abs_delta"].append(float(np.mean(np.abs(
                np.asarray(marked, np.float64) - frames[i]))))
            print(f"p={p} {mask} frame {i}: {time.perf_counter() - start:.1f}"
                  f" s", file=sys.stderr, flush=True)
        out[mask] = rows
    return out


def identify_reference(cases: list[str], frames: np.ndarray,
                       watermark: jnp.ndarray) -> dict:
    sf = strength_factor(PSNR)
    bank = make_bank()
    frame = jnp.asarray(frames[0])
    out: dict = {}
    for case in cases:
        start = time.perf_counter()
        mask, p = case.split(":")
        marked, _ = embed_pipeline(frame, frame, watermark, sf, mask,
                                   p=int(p), impl="xla")
        pair = jnp.stack([marked, frame])
        scores = np.concatenate(
            [np.asarray(detect_many_pipeline(pair, jnp.asarray(bank[i:i + 8]),
                                             mask, p=int(p), impl="xla"))
             for i in range(0, len(bank), 8)], axis=1)
        out[case] = {"marked": scores[0].tolist(),
                     "clean": scores[1].tolist()}
        print(f"identify {case}: {time.perf_counter() - start:.1f} s",
              file=sys.stderr, flush=True)
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--p", type=int, nargs="+", default=[5, 7, 9])
    parser.add_argument("--frames", type=int, nargs="+", default=[0, 5])
    parser.add_argument("--identify", nargs="+", metavar="MASK:P")
    args = parser.parse_args()
    frames = make_frames()
    watermark = jnp.asarray(generate_watermark(ROWS, COLS, SEED))
    if args.identify:
        result = identify_reference(args.identify, frames, watermark)
    else:
        result = {"frames": args.frames}
        for p in args.p:
            result[str(p)] = reference(p, args.frames, frames, watermark)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
