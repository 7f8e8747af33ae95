"""Clamp-to-edge neighborhood primitives shared by all masks.

The reference reads pixels through an OpenCL sampler with
``CLK_ADDRESS_CLAMP_TO_EDGE``; here that is a replicate pad plus static
slices. Neighbor order is the row-major scan of the p x p window with the
center left out (for p=3: top-left, top, top-right, left, right,
bottom-left, bottom, bottom-right). That order is the order of the
predictor coefficients everywhere in the package, the CUDA kernels
included.

All ops are batch-polymorphic: images are (..., H, W).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def neighbor_offsets(p: int = 3) -> tuple[tuple[int, int], ...]:
    """Row-major (row, col) offsets of the p x p window, center excluded."""
    half = p // 2
    return tuple((dr, dc)
                 for dr in range(-half, half + 1)
                 for dc in range(-half, half + 1)
                 if (dr, dc) != (0, 0))


# The p=3 case, index k corresponding to coefficient k.
NEIGHBOR_OFFSETS: tuple[tuple[int, int], ...] = neighbor_offsets(3)

NUM_NEIGHBORS = len(NEIGHBOR_OFFSETS)


def pad_edge(image: torch.Tensor, halo: int) -> torch.Tensor:
    """Replicate-pad the last two dims of (..., H, W) by ``halo`` pixels.

    ``F.pad(mode="replicate")`` wants a leading (N, C) pair for 2-D
    padding, so the leading dims are folded into N (a bare (H, W) gets
    N = 1) and restored afterwards.
    """
    rows, cols = image.shape[-2:]
    lead = image.shape[:-2]
    flat = image.reshape(-1, 1, rows, cols)
    padded = F.pad(flat, (halo, halo, halo, halo), mode="replicate")
    return padded.reshape(*lead, rows + 2 * halo, cols + 2 * halo)


def pad_halo(image: torch.Tensor, halo: int, top: int = 0,
             bottom: int = 0) -> torch.Tensor:
    """Clamp-extend the owned rows of a row-extended shard by ``halo``.

    ``image`` is (..., top + H + bottom, W): H owned rows with ``top`` rows
    above and ``bottom`` below them (true neighbour rows at a shard's seam,
    replicated edge rows at the frame's border). Returns (..., H + 2 halo,
    W + 2 halo): owned rows [-halo, H + halo), rows clamped to the
    extended range [-top, H + bottom - 1], columns clamped to the frame.
    ``top = bottom = 0`` gives ``pad_edge(image, halo)``.
    """
    rows = image.shape[-2] - top - bottom
    return pad_edge(image, halo)[..., top:top + rows + 2 * halo, :]


def shifted_views(padded: torch.Tensor, rows: int, cols: int,
                  p: int = 3) -> list[torch.Tensor]:
    """The p*p-1 neighbor planes (views) of a halo-extended
    (..., rows+2h, cols+2h) array, in coefficient order."""
    half = p // 2
    return [padded[..., half + dr: half + dr + rows,
                   half + dc: half + dc + cols]
            for dr, dc in neighbor_offsets(p)]
