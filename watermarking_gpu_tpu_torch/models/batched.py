"""Batched (multi-frame) embed/detect.

The pipelines take a leading batch axis natively: one call embeds or
detects B frames, at any p in {3, 5, 7, 9}; the per-frame solves run as
one batched solve, and the kernels see the whole stack as one grid.
``BatchedWatermark`` wraps them with the same engine ergonomics as
``Watermark``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.pipelines import _embed_u8_fused, detect_pipeline, embed_pipeline
from .masks import MaskType
from .watermark import Watermark, as_device_input


def batch_embed(images: torch.Tensor, outputs: torch.Tensor,
                watermark: torch.Tensor, strength_factor_value: float,
                mask_type: str, p: int = 3, impl: str = "cuda"
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Embed into (B, H, W[, C]) frames. The watermark matrix is shared."""
    return embed_pipeline(images, outputs, watermark, strength_factor_value,
                          mask_type=mask_type, p=p, impl=impl)


def batch_detect(images: torch.Tensor, watermark: torch.Tensor,
                 mask_type: str, p: int = 3,
                 impl: str = "cuda") -> torch.Tensor:
    """Detector correlations for (B, H, W) frames -> (B,)."""
    return detect_pipeline(images, watermark, mask_type=mask_type, p=p,
                           impl=impl)


def pad_to_batch(stack: np.ndarray, batch_size: int) -> np.ndarray:
    """Pad a partial (B, ...) stack to ``batch_size`` frames by repeating
    the last real frame; callers slice results back to the real count."""
    short = batch_size - stack.shape[0]
    if short <= 0:
        return stack
    return np.concatenate([stack, np.repeat(stack[-1:], short, axis=0)])


def batch_embed_luma_u8(lumas: torch.Tensor, watermark: torch.Tensor,
                        strength_factor_value: float, mask_type: str,
                        p: int = 3, impl: str = "cuda"
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Video path: (B, H, W) uint8 lumas in, uint8 out.

    The u8->f32 widening and the f32->u8 cast both happen on the device, so
    frames cross the host link at one byte a pixel each way. The cast
    truncates, as the reference's ``.as(u8)`` does (``main.cpp:355,379``).
    On ``impl="cuda"`` the lumas widen once, for the analysis, and the
    embed finish reads and writes the uint8 frames.
    """
    if impl == "cuda":
        return _embed_u8_fused(lumas, watermark, strength_factor_value,
                               mask_type, p)
    marked, strength = embed_pipeline(lumas, lumas, watermark,
                                      strength_factor_value,
                                      mask_type=mask_type, p=p, impl=impl)
    return marked.to(torch.uint8), strength


class BatchedWatermark(Watermark):
    """A ``Watermark`` engine whose embed/detect take (B, H, W) stacks."""

    def embed(self, images, outputs=None,
              mask_type: "MaskType | str" = MaskType.ME
              ) -> tuple[torch.Tensor, torch.Tensor]:
        mask_type = MaskType.parse(mask_type)
        images = as_device_input(images, self.device)
        self._check_dims(images[0])
        outputs = images if outputs is None else as_device_input(outputs,
                                                                 self.device)
        return batch_embed(images, outputs, self.random_matrix,
                           self.strength_factor, mask_type.value, p=self.p,
                           impl=self.impl)

    def embed_luma_u8(self, lumas,
                      mask_type: "MaskType | str" = MaskType.ME
                      ) -> tuple[torch.Tensor, torch.Tensor]:
        """(B, H, W) uint8 lumas -> (uint8 watermarked, strengths)."""
        mask_type = MaskType.parse(mask_type)
        lumas = as_device_input(lumas, self.device)
        if lumas.dtype != torch.uint8:
            raise ValueError(f"lumas must be uint8, got {lumas.dtype}")
        self._check_dims(lumas[0])
        return batch_embed_luma_u8(lumas, self.random_matrix,
                                   self.strength_factor, mask_type.value,
                                   p=self.p, impl=self.impl)

    def detect(self, images,
               mask_type: "MaskType | str" = MaskType.ME) -> torch.Tensor:
        mask_type = MaskType.parse(mask_type)
        images = as_device_input(images, self.device)
        self._check_dims(images[0])
        return batch_detect(images, self.random_matrix, mask_type.value,
                            p=self.p, impl=self.impl)
