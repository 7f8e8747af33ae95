"""Host-side IO: watermark matrices (framework-free, shared format with the
JAX package)."""

from .matfile import (WatermarkFileError, generate_watermark, load_watermark,
                      save_watermark)

__all__ = ["WatermarkFileError", "generate_watermark", "load_watermark",
           "save_watermark"]
