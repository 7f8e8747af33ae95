"""The wide-window ME Gram (p in {5, 7, 9}): the lag kernel
(``csrc/me_gram_wide.cu``) and the (B, k+1, k+1) Gram of [k clamped
neighbors; center], k = p*p - 1, assembled from its lane partials.

Counterpart of the JAX package's ``ops/pallas/me_gram_wide.py``. The
kernel's contract is the per-lag lane partials
V_d[v] = sum_{y in [0, H)} P[y, v - h] * P[y + dr, v - h + dc], a
(B, L, W + 2h) tensor over the L canonical lags; its plain version
(``ops.me.lag_partials_plain``) and the assembly (``ops.me.assemble_wide``)
live in ``ops/me.py`` with the rest of the framework-free Gram.

The lag form needs rows, cols >= 6h (the JAX package's own rule,
``ops.me.wide_lag_geometry``); smaller frames take the direct per-pair sums
(``ops.me.gram_direct``) on any device.
"""

from __future__ import annotations

import functools

import torch

from ..me import (assemble_wide, gram_direct, lag_partials_plain, lag_plan,
                  wide_lag_geometry)
from . import build

WIDE_P = (5, 7, 9)


@functools.lru_cache(maxsize=8)
def _slots(p: int, device: torch.device) -> torch.Tensor:
    """The kernel's slot (dc + 2h) * (2h + 1) + dr of each canonical lag,
    in plan order, on ``device``."""
    h = p // 2
    return torch.tensor([(dc + 2 * h) * (2 * h + 1) + dr
                         for dr, dc in lag_plan(p)[0]], device=device)


def wide_gram_partials(image: torch.Tensor, p: int) -> torch.Tensor:
    """(B, H, W) f32 -> (B, L, W + 2h) per-lag lane partials.

    CPU tensors take ``lag_partials_plain``; CUDA tensors launch the kernel,
    which writes every (dr, dc) in [0, 2h] x [-2h, 2h] (the canonical lags
    and 2h that are not) as (B, 4h+1, 2h+1, W + 2h); the canonical ones are
    gathered here in plan order.
    """
    if p not in WIDE_P:
        raise ValueError(f"the wide Gram takes p in {WIDE_P}, got {p}")
    if image.device.type == "cpu":
        return lag_partials_plain(image, p)
    if image.device.type != "cuda" or image.ndim != 3:
        raise ValueError(f"me_gram_wide takes a (B, H, W) CUDA or CPU "
                         f"tensor, got {tuple(image.shape)} on "
                         f"{image.device}")
    batch, rows, cols = image.shape
    build.check_input("image", image, (batch, rows, cols), image.device)
    h = p // 2
    dense = torch.empty((batch, (4 * h + 1) * (2 * h + 1), cols + 2 * h),
                        dtype=torch.float32, device=image.device)
    build.launch("wm_me_gram_wide", image.device, image.data_ptr(),
                 dense.data_ptr(), batch, rows, cols, h)
    me_gram_wide.launches += 1
    return dense[:, _slots(p, image.device)]


def me_gram_wide(image: torch.Tensor, p: int) -> torch.Tensor:
    """(B, H, W) f32 -> (B, k+1, k+1) Gram, k = p*p - 1, p in {5, 7, 9}.

    At rows, cols >= 6h: the lag partials (the kernel on CUDA tensors, its
    plain version on CPU tensors) and ``assemble_wide``. Below that
    geometry the direct per-pair sums, as the JAX package routes such
    frames to its XLA formulation.
    """
    if p not in WIDE_P:
        raise ValueError(f"the wide Gram takes p in {WIDE_P}, got {p}")
    if not wide_lag_geometry(*image.shape[-2:], p):
        return gram_direct(image, p)
    return assemble_wide(wide_gram_partials(image, p), image, p)


me_gram_wide.launches = 0
