"""Command-line tools of the port, counterparts of the JAX package's
``tools/`` scripts of the same names, with their arguments, defaults,
random streams, output lines and exit codes:

    python -m watermarking_gpu_tpu_torch.tools.generate_watermark ...
    python -m watermarking_gpu_tpu_torch.tools.calibrate_threshold ...
    python -m watermarking_gpu_tpu_torch.tools.evaluate_robustness ...

Each has ``main(argv=None, device=None) -> int``. The tools run on the
card: without one they print the command line's message and exit 1.
``device="cpu"`` runs them on the CPU for a caller that asks (the kernels'
plain versions then run). ``calibrate_threshold`` and
``evaluate_robustness`` also take ``results``, a dict that they fill with
the numbers they print, at full precision.
"""

from __future__ import annotations

import time

import torch

from ..cli.main import NO_CARD


def resolve_device(device: "str | torch.device | None"
                   ) -> torch.device | None:
    """``device``, or the card when it is None; None, after the command
    line's message, when there is no card."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        print(NO_CARD)
        return None
    return torch.device("cuda")


def timed_ms(fn, device: torch.device):
    """(fn(), its wall time in ms): CUDA events around the call on the card,
    the host clock elsewhere."""
    if device.type != "cuda":
        start = time.perf_counter()
        result = fn()
        return result, (time.perf_counter() - start) * 1e3
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    result = fn()
    end.record()
    end.synchronize()
    return result, start.elapsed_time(end)
