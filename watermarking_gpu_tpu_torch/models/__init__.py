"""Watermarking engines (model families: NVF mask, prediction-error mask)."""

from .batched import (BatchedWatermark, batch_detect, batch_embed,
                      batch_embed_luma_u8, pad_to_batch)
from .masks import MaskType
from .watermark import Watermark

__all__ = ["BatchedWatermark", "MaskType", "Watermark", "batch_detect",
           "batch_embed", "batch_embed_luma_u8", "pad_to_batch"]
