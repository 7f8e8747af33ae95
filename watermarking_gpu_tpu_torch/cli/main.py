"""settings.ini-driven benchmark CLI, mirroring the reference app, on the card.

Re-implements ``main()`` / ``testForImage`` / video dispatch from
``Watermark_GPU/main.cpp:62-242`` with the observable behaviour of the JAX
package's CLI: warm-up, ``loops_for_test`` averaged timings printed as
seconds or FPS, watermark strength, correlations to 16 decimals, optional
``*_W_NVF`` / ``*_W_ME`` u8 outputs, and ``[paths] video`` switching to the
video pipeline.

Usage: ``python -m watermarking_gpu_tpu_torch [settings.ini]``

The command line runs on an NVIDIA GPU, ``[options] opencl_device`` N
selecting ``cuda:N``. Without a card it prints an error and exits 1; it
never carries on on the CPU. ``main(argv, device="cpu")`` runs on the CPU
only for a caller that asks, such as a test (the kernel wrappers then run
their plain versions).
"""

from __future__ import annotations

import contextlib
import sys
import time

import torch

from ..io import (Settings, add_suffix_before_extension, load_image_rgb,
                  load_settings, save_image_u8)
from ..models import MaskType, Watermark
from ..ops import rgb_to_gray
from ..ops.cuda.build import BUILD_ROOT
from ..utils.timing import Timer, execution_time

MIN_DIM = 64  # main.cpp:161
NO_CARD = ("CUDA is not available (torch.cuda.is_available() is False): "
           "this command runs on an NVIDIA GPU")


def _select_device(index: int) -> torch.device:
    """``cuda:index``, or ``cuda:0`` with the reference's NOTE when the
    index names no card (af::setDevice fallback, main.cpp:72-78)."""
    if not 0 <= index < torch.cuda.device_count():
        print("NOTE: Invalid device specified, using default 0")
        index = 0
    print(f"Using device [{index}]: {torch.cuda.get_device_name(index)} "
          f"(cuda)\n")
    return torch.device("cuda", index)


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(fn, loops: int, pipelined: bool, device: torch.device):
    """(last result, average seconds per call over ``loops`` calls).

    Pipelined (the default) dispatches every call and synchronises once:
    on the card CUDA events around the window, which on one in-order
    stream is the device time of the calls; on the CPU the host clock.
    Blocking mode reproduces the reference's per-call sync loop
    (main.cpp:175-181), ``torch.cuda.synchronize`` after each call.
    """
    if pipelined:
        result = fn()           # the first call of the window's shape
        _synchronize(device)
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(loops):
                result = fn()
            end.record()
            end.synchronize()
            return result, start.elapsed_time(end) / 1e3 / loops
        begin = time.perf_counter()
        for _ in range(loops):
            result = fn()
        return result, (time.perf_counter() - begin) / loops
    total, result = 0.0, None
    for _ in range(loops):
        begin = time.perf_counter()
        result = fn()
        _synchronize(device)
        total += time.perf_counter() - begin
    return result, total / loops


def test_for_image(settings: Settings, device: "str | torch.device") -> int:
    device = torch.device(device)
    show_fps = settings.execution_time_in_fps
    loops = settings.loops_for_test if settings.loops_for_test > 0 else 5
    print(f"Each test will be executed {loops} times. "
          f"Average time will be shown below")

    timer = Timer()
    timer.start()
    rgb = torch.from_numpy(load_image_rgb(settings.image)).to(device)
    image = rgb_to_gray(rgb)
    timer.end(image)
    rows, cols = image.shape
    memory = "HBM" if device.type == "cuda" else "host memory"
    print(f"Time to load and transfer RGB image from disk to {memory}: "
          f"{timer.elapsed_seconds:.6f}\n")

    if rows < MIN_DIM or cols < MIN_DIM:
        print("Image dimensions too low")
        return 1

    engine = Watermark(rows, cols, settings.watermark, p=settings.p,
                       psnr=settings.psnr, device=device)
    if settings.p != 3:
        # capability beyond the reference, which rejects ME at p != 3
        # (main.cpp:88-89 "TODO for p>3 we have problems with ME masking
        # buffers"); the port runs the wide Gram and the p-generic kernels
        print(f"NOTE: ME at p = {settings.p} uses the generalized "
              f"{settings.p * settings.p - 1}-tap predictor "
              f"(reference supports p = 3 only)\n")

    # warm-up (kernel build, allocator) as the reference warms ArrayFire
    # (main.cpp:168-170)
    engine.embed(image, rgb, MaskType.NVF)
    engine.embed(image, rgb, MaskType.ME)
    _synchronize(device)

    def timed(fn):
        return _timed(fn, loops, settings.pipelined_timing, device)

    (watermark_nvf, strength_nvf), secs = timed(
        lambda: engine.embed(image, rgb, MaskType.NVF))
    print(f"Watermark strength (parameter a): {float(strength_nvf)}\n"
          f"Calculation of NVF mask with {rows} rows and {cols} columns "
          f"and parameters:\np = {settings.p}  PSNR(dB) = {settings.psnr}\n"
          f"{execution_time(show_fps, secs)}\n")

    (watermark_me, strength_me), secs = timed(
        lambda: engine.embed(image, rgb, MaskType.ME))
    print(f"Watermark strength (parameter a): {float(strength_me)}\n"
          f"Calculation of ME mask with {rows} rows and {cols} columns "
          f"and parameters:\np = {settings.p}  PSNR(dB) = {settings.psnr}\n"
          f"{execution_time(show_fps, secs)}\n")
    watermarked_me_gray = rgb_to_gray(watermark_me)
    watermarked_nvf_gray = rgb_to_gray(watermark_nvf)

    # warm-up detection
    engine.detect(watermarked_nvf_gray, MaskType.NVF)
    engine.detect(watermarked_me_gray, MaskType.ME)
    _synchronize(device)

    correlation_nvf, secs = timed(
        lambda: engine.detect(watermarked_nvf_gray, MaskType.NVF))
    print(f"Calculation of the watermark correlation (NVF) of an image "
          f"with {rows} rows and {cols} columns and parameters:\n"
          f"p = {settings.p}  PSNR(dB) = {settings.psnr}\n"
          f"{execution_time(show_fps, secs)}\n")

    correlation_me, secs = timed(
        lambda: engine.detect(watermarked_me_gray, MaskType.ME))
    print(f"Calculation of the watermark correlation (ME) of an image "
          f"with {rows} rows and {cols} columns and parameters:\n"
          f"p = {settings.p}  PSNR(dB) = {settings.psnr}\n"
          f"{execution_time(show_fps, secs)}\n")

    print(f"Correlation [NVF]: {float(correlation_nvf):.16f}")
    print(f"Correlation [ME]: {float(correlation_me):.16f}")

    if settings.save_watermarked_files_to_disk:
        print("\nSaving watermarked files to disk...")
        save_image_u8(add_suffix_before_extension(settings.image, "_W_NVF"),
                      watermark_nvf.cpu().numpy())
        save_image_u8(add_suffix_before_extension(settings.image, "_W_ME"),
                      watermark_me.cpu().numpy())
        print("Successfully saved to disk")
    return 0


def main(argv: list[str] | None = None,
         device: "str | torch.device | None" = None) -> int:
    """Run the settings.ini at ``argv[0]`` (default ``settings.ini``) on
    the card the ini names, or on ``device`` when a caller gives one."""
    argv = sys.argv[1:] if argv is None else argv
    settings_path = argv[0] if argv else "settings.ini"
    try:
        settings = load_settings(settings_path)
    except FileNotFoundError:
        print(f"Could not load {settings_path} file")
        return 1

    if settings.compilation_cache_dir:
        print(f"NOTE: compilation_cache_dir is not used: the kernels are "
              f"built once per source hash into {BUILD_ROOT}")

    if device is None:
        if not torch.cuda.is_available():
            print(NO_CARD)
            return 1
        device = _select_device(settings.device)
    else:
        device = torch.device(device)
        print(f"Using device: {device} (requested by the caller)\n")

    if settings.p not in (3, 5, 7, 9):
        print("p parameter must be one of 3, 5, 7, 9")
        return 1
    if settings.psnr <= 0:
        print("PSNR must be a positive number")
        return 1

    try:
        # honour the [options] device index (af::setDevice analog,
        # main.cpp:73-77): the kernels launch on its current stream
        with (torch.cuda.device(device) if device.type == "cuda"
              else contextlib.nullcontext()):
            if settings.is_video_mode:
                from ..video.pipeline import test_for_video
                return test_for_video(settings, device)
            return test_for_image(settings, device)
    except Exception as exc:  # mirror the reference's catch-all (main.cpp:132)
        print(exc)
        return 1


if __name__ == "__main__":
    sys.exit(main())
