"""Normalized correlation detector.

Reference (``Watermark.cpp:228-231``)::

    corr = dot(flat(e_u), flat(e_z)) / (||e_z|| * ||e_u||)

Batch-polymorphic: error sequences (..., H, W) -> correlations (...,).
"""

from __future__ import annotations

import torch


def correlation(e_u: torch.Tensor, e_z: torch.Tensor) -> torch.Tensor:
    """Per-image cosine similarity between two error sequences."""
    dims = (-2, -1)
    dot = (e_u * e_z).sum(dim=dims)
    norm_u = (e_u * e_u).sum(dim=dims)
    norm_z = (e_z * e_z).sum(dim=dims)
    return dot / (torch.sqrt(norm_z) * torch.sqrt(norm_u))
