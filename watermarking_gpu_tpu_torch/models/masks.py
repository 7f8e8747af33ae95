"""Mask-type enumeration (the two watermarking model families).

Mirrors ``MASK_TYPE`` in ``Watermark_GPU/Watermark.hpp:10-14``.
"""

from __future__ import annotations

import enum


class MaskType(enum.Enum):
    ME = "me"    # prediction-error mask
    NVF = "nvf"  # noise-visibility-function (local variance) mask

    @classmethod
    def parse(cls, value: "MaskType | str") -> "MaskType":
        if isinstance(value, cls):
            return value
        return cls(value.lower())
