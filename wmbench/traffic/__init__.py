"""Traffic: the mixes (``<mix>.json``, data) and the loops that drive them
(``<kind>.py``, one module a kind, named by a mix's ``kind``)."""

from __future__ import annotations

import time

import torch


def inputs_ready(ctx) -> None:
    """Free what making the inputs left behind and start the memory peak
    from here, so that ``memory_peak_bytes`` holds the inputs the cell
    keeps and what the program takes, not the set-up's scratch; mark the
    time, which splits the set-up into the inputs and the program's
    warm-up."""
    device = ctx.device
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    ctx.marks["inputs"] = time.perf_counter()
