#!/usr/bin/env python3
"""Compute, with the JAX package on the CPU, the reference numbers that
``chip_smoke.py`` holds the PyTorch port to on the GPU.

    JAX_PLATFORMS=cpu python tools/chip_smoke_reference.py --p 5 7 9 \
        --frames 0 5
    JAX_PLATFORMS=cpu python tools/chip_smoke_reference.py \
        --identify me:3 nvf:3 me:5
    JAX_PLATFORMS=cpu python tools/chip_smoke_reference.py --cli --video
    JAX_PLATFORMS=cpu python tools/chip_smoke_reference.py --tools

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

With ``--tools``: the numbers of ``chip_smoke.py`` phase 7, in the layout
of ``chip_smoke.JAX_TOOLS_REFERENCE``, from the JAX package's own tools and
examples run in process (``run_jax_*`` below), their engines wrapped so that
what they compute is recorded at full precision, not as printed.
``chip_smoke.make_cli_image()`` as a PNG and ``generate_watermark(1080,
1920, 28390211)`` as a ``.dat``: ``tools/calibrate_threshold.py`` at its
defaults for ME p=3, NVF p=3 and ME p=5 (``CALIBRATE_RUNS``),
``tools/evaluate_robustness.py`` for ME and NVF p=3, the image and the
identification examples on the PNG, the video and serving examples at
their own sizes.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import io
import json
import os
import sys
import tempfile
import time
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import (CALIBRATE_RUNS, CLI_P, COLS, IDENTIFY_N,  # noqa
                        PSNR, ROBUSTNESS_MASKS, ROWS, SEED, VIDEO_BATCH,
                        VIDEO_FRAMES, VIDEO_INTERVALS, VIDEO_SEED, make_bank,
                        make_cli_image, make_frames)
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


REPO = Path(__file__).resolve().parents[1]


def load_script(relative: str) -> types.ModuleType:
    """A fresh module of one of the JAX package's scripts (``tools/`` or
    ``examples/``), under a name of its own."""
    name = "jax_" + relative.replace("/", "_").removesuffix(".py")
    spec = importlib.util.spec_from_file_location(name, REPO / relative)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def recording(engine_cls: type, log: list) -> type:
    """``engine_cls`` whose embed, detect and detect_many append
    (method, numpy result) to ``log`` (embed: its strength)."""
    class Recording(engine_cls):
        def embed(self, *args, **kwargs):
            out = super().embed(*args, **kwargs)
            log.append(("embed", np.asarray(out[1])))
            return out

        def detect(self, *args, **kwargs):
            out = super().detect(*args, **kwargs)
            log.append(("detect", np.asarray(out)))
            return out

        def detect_many(self, *args, **kwargs):
            out = super().detect_many(*args, **kwargs)
            log.append(("detect_many", np.asarray(out)))
            return out
    return Recording


def run_main(module: types.ModuleType, argv: list[str]) -> tuple:
    """(main's return value, its stdout): a script's ``main()`` that reads
    ``sys.argv``, run with ``argv`` as its arguments."""
    old_argv, buffer = sys.argv, io.StringIO()
    sys.argv = [module.__file__, *argv]
    try:
        with contextlib.redirect_stdout(buffer):
            rc = module.main()
    finally:
        sys.argv = old_argv
    return rc, buffer.getvalue()


def run_jax_calibrate(argv: list[str]) -> dict:
    """``tools/calibrate_threshold.py`` with ``argv``: its exit code and
    lines, the null matrix, the signals and the statistics it prints, in
    the layout of the port's ``results``."""
    module = load_script("tools/calibrate_threshold.py")
    log: list = []
    module.Watermark = recording(module.Watermark, log)
    rc, out = run_main(module, argv)
    nulls = next(r for kind, r in log if kind == "detect_many")
    signals = np.asarray([float(r) for kind, r in log if kind == "detect"])
    per_image_std = nulls.std(axis=1, ddof=1)
    fpr = float(argv[argv.index("--fpr") + 1]) if "--fpr" in argv else 1e-6
    z = module._z_for(fpr)
    mean, sigma = float(nulls.mean()), float(per_image_std.max())
    return {"rc": rc, "out": out, "nulls": nulls, "signals": signals,
            "mean": mean, "std_min": float(per_image_std.min()),
            "std_max": sigma, "max": float(nulls.max()), "z": z,
            "threshold": mean + z * sigma,
            "signal_mean": float(signals.mean()),
            "signal_min": float(signals.min())}


def run_jax_robustness(argv: list[str]) -> dict:
    """``tools/evaluate_robustness.py`` with ``argv``: its exit code and
    lines, the strength and {attack: correlation}."""
    module = load_script("tools/evaluate_robustness.py")
    log: list = []
    module.BatchedWatermark = recording(module.BatchedWatermark, log)
    rc, out = run_main(module, argv)
    lines = out.splitlines()
    names = [line.rsplit(None, 1)[0].strip()
             for line in lines[lines.index(next(
                 line for line in lines if line.startswith("attack"))) + 1:]]
    corrs = next(r for kind, r in log if kind == "detect")
    strength = next(r for kind, r in log if kind == "embed")
    return {"rc": rc, "out": out, "strength": float(strength[0]),
            "rows": dict(zip(names, map(float, corrs)))}


def run_jax_image_example(image: str, dat: str, out_dir: str) -> dict:
    """``examples/image_watermark.py image dat``, its PNGs written to
    ``out_dir``: {mask name: {"strength", "corr_marked", "corr_clean"}}."""
    module = load_script("examples/image_watermark.py")
    log: list = []
    module.Watermark = recording(module.Watermark, log)
    save = module.save_image_u8
    module.save_image_u8 = lambda path, image: save(
        os.path.join(out_dir, os.path.basename(path)), image)
    run_main(module, [image, dat])
    values = [float(r) for _, r in log]
    return {name: dict(zip(("strength", "corr_marked", "corr_clean"),
                           values[3 * i:3 * i + 3]))
            for i, name in enumerate(("NVF", "ME"))}


def run_jax_identify_example(image: str, n: int) -> dict:
    """``examples/identify_watermark.py image n``: {"strength", "corrs"}."""
    module = load_script("examples/identify_watermark.py")
    log: list = []
    module.Watermark = recording(module.Watermark, log)
    run_main(module, [image, str(n)])
    return {"strength": float(log[0][1]), "corrs": log[1][1].tolist()}


def run_jax_video_example() -> dict:
    """``examples/video_watermark.py``: the per-frame correlations of the
    marked and of the clean clip."""
    module = load_script("examples/video_watermark.py")
    runs: list = []
    detect = module.detect_video

    def recorded(settings, *args, **kwargs):
        out = detect(settings, *args, **kwargs)
        runs.append([corr for _, corr in out[1]])
        return out
    module.detect_video = recorded
    with tempfile.TemporaryDirectory() as tmp:
        module.tempfile = types.SimpleNamespace(
            mkdtemp=lambda prefix: tempfile.mkdtemp(prefix=prefix, dir=tmp))
        run_main(module, [])
    return {"marked": runs[0], "clean": runs[1]}


def run_jax_serving_example() -> dict:
    """``examples/serving_demo.py``: the detector's correlations and the
    identifier's scores."""
    module = load_script("examples/serving_demo.py")
    futures: dict = {"detector": [], "identifier": []}

    def recording_service(cls, key):
        class Recorded(cls):
            def submit(self, *args, **kwargs):
                future = super().submit(*args, **kwargs)
                futures[key].append(future)
                return future
        return Recorded
    module.DetectorService = recording_service(module.DetectorService,
                                               "detector")
    module.IdentifierService = recording_service(module.IdentifierService,
                                                 "identifier")
    run_main(module, [])
    return {"corrs": [float(f.result()) for f in futures["detector"]],
            "scores": np.asarray(futures["identifier"][0].result()).tolist()}


def tools_reference() -> dict:
    """Phase 7's numbers (``chip_smoke.JAX_TOOLS_REFERENCE``)."""
    out: dict = {"calibrate": {}, "robustness": {}}
    with tempfile.TemporaryDirectory() as tmp:
        png = os.path.join(tmp, "frame.png")
        write_png(png, make_cli_image())
        dat = os.path.join(tmp, "w.dat")
        save_watermark(dat, generate_watermark(ROWS, COLS, SEED))
        for name, argv in CALIBRATE_RUNS.items():
            start = time.perf_counter()
            got = run_jax_calibrate([png, *argv])
            if got["rc"] != 0:
                raise SystemExit(f"calibrate {name}:\n{got['out']}")
            out["calibrate"][name] = {
                key: got[key] for key in (
                    "mean", "std_min", "std_max", "max", "z", "threshold",
                    "signal_mean", "signal_min")}
            out["calibrate"][name]["signals"] = got["signals"].tolist()
            print(f"calibrate {name}: {time.perf_counter() - start:.1f} s",
                  file=sys.stderr, flush=True)
        for mask in ROBUSTNESS_MASKS:
            start = time.perf_counter()
            got = run_jax_robustness([png, "--mask", mask])
            out["robustness"][mask] = {"strength": got["strength"],
                                       "rows": got["rows"]}
            print(f"robustness {mask}: {time.perf_counter() - start:.1f} s",
                  file=sys.stderr, flush=True)
        start = time.perf_counter()
        out["image_example"] = run_jax_image_example(png, dat, tmp)
        out["identify_example"] = run_jax_identify_example(png, IDENTIFY_N)
        print(f"image and identify examples: "
              f"{time.perf_counter() - start:.1f} s", file=sys.stderr,
              flush=True)
    start = time.perf_counter()
    out["video_example"] = run_jax_video_example()
    out["serving_example"] = run_jax_serving_example()
    print(f"video and serving examples: {time.perf_counter() - start:.1f} s",
          file=sys.stderr, flush=True)
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--p", type=int, nargs="+", default=[5, 7, 9])
    parser.add_argument("--frames", type=int, nargs="+", default=[0, 5])
    parser.add_argument("--identify", nargs="+", metavar="MASK:P")
    parser.add_argument("--cli", action="store_true")
    parser.add_argument("--video", action="store_true")
    parser.add_argument("--tools", action="store_true")
    args = parser.parse_args()
    if args.tools:
        print(json.dumps(tools_reference()))
        return 0
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
