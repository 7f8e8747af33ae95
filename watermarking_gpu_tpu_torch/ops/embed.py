"""Watermark embedding math.

Reference (``Watermark.cpp:156-172``)::

    u        = mask * W
    strength = strengthFactor / (||u|| / sqrt(N))   # 255/sqrt(10^(psnr/10))
    output   = clamp(output + u * strength, 0, 255)

When ``output`` is RGB the grayscale ``u`` broadcasts over the channel axis.
``u * strength = strengthFactor * sqrt(N) * u/||u||`` is invariant to any
positive rescaling of the mask, so the ME mask's ``1/max|e|`` only changes
the reported strength; the fused route relies on that.

Batch-polymorphic: masks/watermarks (..., H, W); outputs (..., H, W) or
(..., H, W, 3); strengths (...,).
"""

from __future__ import annotations

import math

import torch


def strength_factor(psnr: float) -> float:
    """255 / sqrt(10^(psnr/10)) (Watermark.cpp:22)."""
    return 255.0 / math.sqrt(10.0 ** (psnr / 10.0))


def embed_watermark(output: torch.Tensor, mask: torch.Tensor,
                    watermark: torch.Tensor, strength_factor_value: float
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Additive spread-spectrum embed. Returns (watermarked, strengths)."""
    u = mask * watermark
    n = u.shape[-1] * u.shape[-2]
    norm_sq = (u * u).sum(dim=(-2, -1))
    strength = strength_factor_value / torch.sqrt(norm_sq / n)
    addend = u * strength[..., None, None]
    if output.ndim == mask.ndim + 1:  # (..., H, W, C): broadcast channels
        addend = addend[..., None]
    return torch.clamp(output + addend, 0.0, 255.0), strength
