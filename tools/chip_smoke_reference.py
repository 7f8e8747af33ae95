#!/usr/bin/env python3
"""Compute, with the JAX package on the CPU, the reference numbers that
``chip_smoke.py`` holds the PyTorch port to on the GPU.

    JAX_PLATFORMS=cpu python tools/chip_smoke_reference.py --p 5 7 9 \
        --frames 0 5

For each window size p and mask, frame by frame (``impl="xla"``, the JAX
package's oracle): ``embed_pipeline(frame, frame, W, strength_factor(40),
mask, p)``, then ``detect_pipeline`` on the marked frame ("corr") and on
the clean one ("clean_corr"), and mean |marked - frame| ("mean_abs_delta").
The frames and watermark are the ones ``chip_smoke.make_frames()`` and
``generate_watermark(1080, 1920, 28390211)`` give. Prints one JSON object
keyed by p, in the layout of ``chip_smoke.JAX_WIDE_REFERENCE``.
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

from chip_smoke import COLS, PSNR, ROWS, SEED, make_frames  # noqa: E402
from watermarking_gpu_tpu.io.matfile import generate_watermark  # noqa: E402
from watermarking_gpu_tpu.ops.embed import strength_factor  # noqa: E402
from watermarking_gpu_tpu.ops.pipelines import (  # noqa: E402
    detect_pipeline, embed_pipeline)


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


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--p", type=int, nargs="+", default=[5, 7, 9])
    parser.add_argument("--frames", type=int, nargs="+", default=[0, 5])
    args = parser.parse_args()
    frames = make_frames()
    watermark = jnp.asarray(generate_watermark(ROWS, COLS, SEED))
    result = {"frames": args.frames}
    for p in args.p:
        result[str(p)] = reference(p, args.frames, frames, watermark)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
