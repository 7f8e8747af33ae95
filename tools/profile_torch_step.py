#!/usr/bin/env python3
"""Where the time of the PyTorch port's main-path step goes, on one GPU.

    python tools/profile_torch_step.py --p 3 5 7 9 --impl cuda torch
    python tools/profile_torch_step.py --identify --p 3 5 7 9 --impl cuda

For each window p and route, the chained 8-frame 1080p ME embed+detect
step that ``chip_smoke.py`` phase 4 times: 20 warm-up steps, then
``torch.profiler`` (CPU and CUDA activities) over 5 steps. With
``--identify`` the step is instead ``BatchedWatermark.detect_many`` of the
8 frames against ``chip_smoke.make_bank()``'s 64 candidates (ME), after 3
warm-up steps. Prints per step: wall ms (host clock around the
synchronised window), device busy ms (the sum of the kernels' device time;
one stream, so they do not overlap), the busy share, the number of device
kernels, and the kernels that take the most device time, each with its
share of the busy time; and, before the profiler starts, the host's ms to
enqueue a step (the host clock around 20 steps with no synchronize
between them: the card runs behind without pacing the host while its
launch queue has room). Needs a GPU; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import (BATCH, COLS, PSNR, ROWS, SEED,  # noqa: E402
                        make_bank, make_frames)
from watermarking_gpu_tpu_torch.io.matfile import \
    generate_watermark  # noqa: E402
from watermarking_gpu_tpu_torch.models import (  # noqa: E402
    BatchedWatermark, batch_detect, batch_embed)
from watermarking_gpu_tpu_torch.ops import strength_factor  # noqa: E402

STEPS = 5


def round_trip_step(p: int, impl: str, frames: torch.Tensor,
                    wm: torch.Tensor):
    sf = strength_factor(PSNR)
    state = {"frames": frames}

    def step():
        marked, _ = batch_embed(state["frames"], state["frames"], wm, sf,
                                "me", p=p, impl=impl)
        batch_detect(marked, wm, "me", p=p, impl=impl)
        state["frames"] = marked
    return step


def identify_step(p: int, impl: str, frames: torch.Tensor,
                  bank: torch.Tensor):
    engine = BatchedWatermark(ROWS, COLS, SEED, p=p, psnr=PSNR, impl=impl,
                              device="cuda")
    return lambda: engine.detect_many(frames, bank)


def host_ms(step, steps: int = 20) -> float:
    """Host ms to enqueue a step, over ``steps`` steps after a
    synchronize."""
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(steps):
        step()
    seconds = time.perf_counter() - start
    torch.cuda.synchronize()
    return seconds * 1e3 / steps


def profile(p: int, impl: str, step, warmup: int, top: int) -> None:
    for _ in range(warmup):
        step()
    host = host_ms(step)
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        start = time.perf_counter()
        for _ in range(STEPS):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3 / STEPS
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.device_time_total for e in kernels) / 1e3 / STEPS
    print(f"p={p} impl={impl}: wall {wall_ms:.3f} ms/step "
          f"({BATCH * 1e3 / wall_ms:.1f} fps), device busy {busy_ms:.3f} "
          f"ms/step ({100 * busy_ms / wall_ms:.1f}%), "
          f"{len(kernels) / STEPS:.0f} device kernels/step; host "
          f"{host:.3f} ms/step to enqueue (20 steps, no synchronize)",
          flush=True)
    by_name: dict[str, list[float]] = {}
    for event in kernels:
        by_name.setdefault(event.name, []).append(event.device_time_total)
    ranked = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:top]
    for name, times in ranked:
        ms = sum(times) / 1e3 / STEPS
        print(f"    {ms:8.4f} ms/step ({100 * ms / busy_ms:4.1f}% of busy) "
              f"{len(times) / STEPS:5.0f} launches/step  {name[:100]}",
              flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--p", type=int, nargs="+", default=[3, 5, 7, 9])
    parser.add_argument("--impl", nargs="+", default=["cuda", "torch"])
    parser.add_argument("--top", type=int, default=8)
    parser.add_argument("--identify", action="store_true",
                        help="profile detect_many against 64 candidates")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("needs a GPU: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    frames = torch.from_numpy(make_frames()).cuda()
    if args.identify:
        make_step, warmup = identify_step, 3
        data = torch.from_numpy(make_bank()).cuda()
    else:
        make_step, warmup = round_trip_step, 20
        data = torch.from_numpy(generate_watermark(ROWS, COLS, SEED).astype(
            np.float32)).cuda()
    for p in args.p:
        for impl in args.impl:
            profile(p, impl, make_step(p, impl, frames, data), warmup,
                    args.top)
    return 0


if __name__ == "__main__":
    sys.exit(main())
