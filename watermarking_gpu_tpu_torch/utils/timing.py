"""Wall-clock timing with device synchronization.

Analog of the reference ``timer`` namespace (``Utilities.hpp:20-26``).
PyTorch returns from a CUDA op before the device finishes, so a timed
section ends with ``torch.cuda.synchronize`` on the devices of the values
it produced.
"""

from __future__ import annotations

import time

import torch


class Timer:
    def __init__(self):
        self._start = 0.0
        self._end = 0.0

    def start(self) -> None:
        self._start = time.perf_counter()

    def end(self, *sync_values: torch.Tensor) -> None:
        """Stop the clock, first waiting for the devices that hold any of
        ``sync_values``."""
        for device in {v.device for v in sync_values if v.is_cuda}:
            torch.cuda.synchronize(device)
        self._end = time.perf_counter()

    @property
    def elapsed_seconds(self) -> float:
        return self._end - self._start


def execution_time(show_fps: bool, seconds: float) -> str:
    """Format like the reference (main.cpp:464-467)."""
    if show_fps:
        return f"FPS: {1.0 / seconds:.2f} FPS"
    return f"{seconds:.6f} seconds"
