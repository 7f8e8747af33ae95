"""Color conversion: BT.601 luma on 0..255 float data, as the reference's
``af::rgb2gray(rgb, 0.299, 0.587, 0.114)`` (``main.cpp:142-144,154``)."""

from __future__ import annotations

import torch

BT601_WEIGHTS = (0.299, 0.587, 0.114)


def rgb_to_gray(rgb: torch.Tensor,
                weights: tuple[float, float, float] = BT601_WEIGHTS
                ) -> torch.Tensor:
    """(..., H, W, 3) -> (..., H, W) luma. Passes 2D inputs through."""
    if rgb.ndim == 2:
        return rgb
    return (rgb[..., 0] * weights[0] + rgb[..., 1] * weights[1]
            + rgb[..., 2] * weights[2])
