"""Host-side IO: images, watermark matrices, configuration (framework-free;
the formats the JAX package reads and writes)."""

from .config import Settings, load_settings
from .images import (add_suffix_before_extension, load_image_gray,
                     load_image_rgb, save_image_u8)
from .matfile import (WatermarkFileError, generate_watermark, load_watermark,
                      save_watermark)

__all__ = [
    "Settings", "WatermarkFileError", "add_suffix_before_extension",
    "generate_watermark", "load_image_gray", "load_image_rgb",
    "load_settings", "load_watermark", "save_image_u8", "save_watermark",
]
