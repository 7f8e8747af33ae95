"""NVF (Noise Visibility Function) perceptual mask.

For each pixel, over a p x p clamp-to-edge window (reference
``kernels/nvf.hpp:37-50``)::

    mean     = sum / p^2
    variance = sumSq / p^2 - mean^2
    mask     = variance / (1 + variance)

Box sums are taken with shifted slices: per row, the sum over the window's
columns, then the sum of those over the window's rows (the order the CUDA
kernels use). Not ``conv2d``/``avg_pool2d``: cuDNN runs f32 convolutions in
TF32 by default, which keeps about three decimal digits.
"""

from __future__ import annotations

import torch

from .neighbors import pad_edge


def nvf_mask(image: torch.Tensor, p: int = 3) -> torch.Tensor:
    """Local-variance visibility mask over a p x p window (p odd >= 3)."""
    half = p // 2
    rows, cols = image.shape[-2:]
    padded = pad_edge(image, half)
    col_sum = padded[..., :, 0:cols]
    col_sq = col_sum * col_sum
    for dc in range(1, p):
        sl = padded[..., :, dc:dc + cols]
        col_sum = col_sum + sl
        col_sq = col_sq + sl * sl
    total = col_sum[..., 0:rows, :]
    total_sq = col_sq[..., 0:rows, :]
    for dr in range(1, p):
        total = total + col_sum[..., dr:dr + rows, :]
        total_sq = total_sq + col_sq[..., dr:dr + rows, :]
    inv_p2 = 1.0 / float(p * p)
    mean = total * inv_p2
    variance = total_sq * inv_p2 - mean * mean
    return variance / (1.0 + variance)
