"""Raw YUV420p frame layout helpers.

The reference streams raw yuv420p between the decoder, the watermark engine
and the ffmpeg encoder pipe (``Watermark_GPU/main.cpp:287,359,384-386``).
Frame layout: full-res luma plane then quarter-res U and V planes, 8 bits
each: ``w*h*3/2`` bytes per frame. Framework-free: the same helpers as the
JAX package's, kept here so the port imports nothing of it.
"""

from __future__ import annotations

import numpy as np


def frame_bytes(width: int, height: int) -> int:
    return width * height * 3 // 2


def split_planes(frame: np.ndarray, width: int,
                 height: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Flat uint8 frame -> (luma (H, W), u (H/2, W/2), v (H/2, W/2)) views."""
    luma_size = width * height
    chroma_size = luma_size // 4
    luma = frame[:luma_size].reshape(height, width)
    u = frame[luma_size:luma_size + chroma_size].reshape(height // 2,
                                                         width // 2)
    v = frame[luma_size + chroma_size:].reshape(height // 2, width // 2)
    return luma, u, v


def join_planes(luma: np.ndarray, u: np.ndarray, v: np.ndarray) -> bytes:
    return luma.tobytes() + u.tobytes() + v.tobytes()


def synthesize(width: int, height: int, num_frames: int,
               seed: int = 0) -> bytes:
    """Generate a synthetic yuv420p clip (textured luma, flat chroma)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    out = []
    for t in range(num_frames):
        base = 110 + 70 * np.sin(xx / 9.0 + t * 0.3) * np.cos(yy / 7.0)
        noise = rng.normal(0, 14, size=(height, width))
        luma = np.clip(base + noise, 0, 255).astype(np.uint8)
        chroma = np.full((height // 2, width // 2), 128, dtype=np.uint8)
        out.append(join_planes(luma, chroma, chroma))
    return b"".join(out)
