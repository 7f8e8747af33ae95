#!/usr/bin/env python3
"""Compute, with the JAX package on the CPU, the reference numbers that
``chip_smoke.py`` holds the PyTorch port to on the GPU.

    JAX_PLATFORMS=cpu python tools/chip_smoke_reference.py --p 5 7 9 \
        --frames 0 5
    JAX_PLATFORMS=cpu python tools/chip_smoke_reference.py \
        --identify me:3 nvf:3 me:5
    JAX_PLATFORMS=cpu python tools/chip_smoke_reference.py --cli --video

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

With ``--cli`` and/or ``--video``: the numbers of ``chip_smoke.py`` phase 5,
in the layout of ``chip_smoke.JAX_ENTRY_REFERENCE``. ``--cli``: for p = 3
and 5 (``chip_smoke.CLI_P``), ``chip_smoke.make_cli_image()`` written by the
port's PNG writer and read back by the JAX package's loader (Pillow), then
what the JAX CLI computes from it (``Watermark(..., impl="xla")``): the NVF
and ME strengths of ``embed(gray, rgb, mask)`` and the correlations of
``detect`` on the watermarked image's gray. ``--video``: the JAX
``embed_video`` of ``synthesize(1920, 1080, VIDEO_FRAMES, seed=VIDEO_SEED)``
at each of ``VIDEO_INTERVALS`` (batches of 8), then the correlations
``detect_video`` prints for each output at its interval and for the clean
clip at interval 1.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import (CLI_P, COLS, PSNR, ROWS, SEED,  # noqa: E402
                        VIDEO_BATCH, VIDEO_FRAMES, VIDEO_INTERVALS,
                        VIDEO_SEED, make_bank, make_cli_image, make_frames)
from watermarking_gpu_tpu.io.config import Settings  # noqa: E402
from watermarking_gpu_tpu.io.images import load_image_rgb  # noqa: E402
from watermarking_gpu_tpu.io.matfile import generate_watermark  # noqa: E402
from watermarking_gpu_tpu.models import MaskType, Watermark  # noqa: E402
from watermarking_gpu_tpu.ops import rgb_to_gray  # noqa: E402
from watermarking_gpu_tpu.ops.embed import strength_factor  # noqa: E402
from watermarking_gpu_tpu.ops.pipelines import (  # noqa: E402
    detect_many_pipeline, detect_pipeline, embed_pipeline)
from watermarking_gpu_tpu.video import (detect_video, embed_video,  # noqa
                                        synthesize)
from watermarking_gpu_tpu_torch.io.images import write_png  # noqa: E402
from watermarking_gpu_tpu_torch.io.matfile import \
    save_watermark  # noqa: E402


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


def cli_reference(watermark: np.ndarray) -> dict:
    image = make_cli_image()
    with tempfile.TemporaryDirectory() as tmp:
        png = os.path.join(tmp, "frame.png")
        write_png(png, image)
        rgb = load_image_rgb(png)
    if not np.array_equal(rgb, image.astype(np.float32)):
        raise SystemExit("Pillow read the port's PNG as another image")
    rgb = jnp.asarray(rgb)
    gray = rgb_to_gray(rgb)
    out: dict = {}
    for p in CLI_P:
        start = time.perf_counter()
        engine = Watermark(ROWS, COLS, watermark, p=p, psnr=PSNR,
                           impl="xla")
        row = {}
        for mask in (MaskType.NVF, MaskType.ME):
            marked, strength = engine.embed(gray, rgb, mask)
            row[f"strength_{mask.value}"] = float(strength)
            row[f"corr_{mask.value}"] = float(
                engine.detect(rgb_to_gray(marked), mask))
        out[str(p)] = row
        print(f"cli p={p}: {time.perf_counter() - start:.1f} s",
              file=sys.stderr, flush=True)
    return out


def video_reference(watermark: np.ndarray) -> dict:
    out: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        clip = os.path.join(tmp, "clip.yuv")
        with open(clip, "wb") as f:
            f.write(synthesize(COLS, ROWS, VIDEO_FRAMES, seed=VIDEO_SEED))
        dat = os.path.join(tmp, "w.dat")
        save_watermark(dat, watermark)

        def settings(path, interval, **kw):
            return Settings(video=path, watermark=dat, p=3, psnr=PSNR,
                            watermark_interval=interval,
                            embed_batch=VIDEO_BATCH,
                            detect_batch=VIDEO_BATCH,
                            raw_video_size=f"{COLS}x{ROWS}", **kw)
        runs = [("clean", clip, 1)]
        for interval in VIDEO_INTERVALS:
            start = time.perf_counter()
            marked = os.path.join(tmp, f"marked_{interval}.yuv")
            embed_video(settings(clip, interval,
                                 encode_watermark_file_path=marked),
                        out=io.StringIO())
            runs.insert(-1, (f"interval{interval}", marked, interval))
            print(f"video embed at interval {interval}: "
                  f"{time.perf_counter() - start:.1f} s", file=sys.stderr,
                  flush=True)
        for name, path, interval in runs:
            start = time.perf_counter()
            _, results = detect_video(settings(path, interval),
                                      out=io.StringIO())
            out[name] = [c for _, c in results]
            print(f"video detect {name}: {time.perf_counter() - start:.1f} s",
                  file=sys.stderr, flush=True)
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--p", type=int, nargs="+", default=[5, 7, 9])
    parser.add_argument("--frames", type=int, nargs="+", default=[0, 5])
    parser.add_argument("--identify", nargs="+", metavar="MASK:P")
    parser.add_argument("--cli", action="store_true")
    parser.add_argument("--video", action="store_true")
    args = parser.parse_args()
    if args.cli or args.video:
        matrix = generate_watermark(ROWS, COLS, SEED)
        result = {}
        if args.cli:
            result["cli"] = cli_reference(matrix)
        if args.video:
            result["video"] = video_reference(matrix)
        print(json.dumps(result))
        return 0
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
