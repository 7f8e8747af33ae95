"""Debug array viewer.

Parity with ``Watermark::displayArray`` (``Watermark_GPU/Watermark.cpp:
253-258``), which opens an ``af::Window`` GUI loop. GPU hosts are headless,
so, as in the JAX package, the array is rendered to a PNG (auto-scaled to
0..255 when needed) through the port's own PNG writer; there is no viewer
to hand it to.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from ..io.images import write_png


def display_array(array, path: str | None = None) -> str:
    """Render a 2D/3D array (numpy, or a tensor on any device) to a PNG for
    inspection. Returns the path."""
    if isinstance(array, torch.Tensor):
        array = array.detach().cpu().numpy()
    arr = np.asarray(array, dtype=np.float32)
    lo, hi = float(arr.min()), float(arr.max())
    if hi <= 1.0 and lo >= 0.0:
        arr = arr * 255.0
    elif hi > 255.0 or lo < 0.0:
        arr = (arr - lo) / max(hi - lo, 1e-12) * 255.0
    if path is None:
        fd, path = tempfile.mkstemp(suffix=".png", prefix="wm_display_")
        os.close(fd)
    write_png(path, arr.astype(np.uint8))
    return path
