"""The wide-window ME Gram (p in {5, 7, 9}): the (B, k+1, k+1) Gram of
[k clamped neighbors; center], k = p*p - 1, from two kernels
(``csrc/me_gram_wide.cu``).

Counterpart of the JAX package's ``ops/pallas/me_gram_wide.py``
(``me_gram_wide_raw``: the lag kernel and the assembly it returns with).

1. The lag kernel (``wide_lag_strips``) sums each canonical lag's products
   over strips of rows: per (image, lag, strip, lane block) the sum over the
   block's lanes, and per (image, lag, strip) the 2h left and 2h right edge
   lanes. Its plain version is ``ops.me.lag_strips_plain``.
2. The assembly kernel (``wide_assemble``) adds those up, takes the column
   windows, computes the boundary-row corrections from the image and writes
   the Gram. Its plain version is ``ops.me.assemble_strips_plain``.

On CPU tensors ``me_gram_wide`` chains the two plain versions. The lag form
needs rows, cols >= 6h (the JAX package's own rule,
``ops.me.wide_lag_geometry``); smaller frames take the direct per-pair sums
(``ops.me.gram_direct``) on any device.
"""

from __future__ import annotations

import functools
import itertools

import torch

from ..me import (LANE_BLOCK, assemble_strips_plain, gram_direct, lag_plan,
                  lag_strips_plain, wide_lag_geometry, wide_lag_layout)
from . import build

WIDE_P = (5, 7, 9)


def _check_p(p: int) -> None:
    if p not in WIDE_P:
        raise ValueError(f"the wide Gram takes p in {WIDE_P}, got {p}")


def _check_image(image: torch.Tensor, p: int) -> None:
    if image.device.type != "cuda" or image.ndim != 3:
        raise ValueError(f"me_gram_wide takes a (B, H, W) CUDA or CPU "
                         f"tensor, got {tuple(image.shape)} on "
                         f"{image.device}")
    build.check_input("image", image, tuple(image.shape), image.device)
    if not wide_lag_geometry(*image.shape[-2:], p):
        raise ValueError(f"the wide Gram kernels need rows, cols >= "
                         f"{6 * (p // 2)} at p={p}, got "
                         f"{tuple(image.shape[-2:])}")


@functools.lru_cache(maxsize=8)
def _tables(p: int, device: torch.device) -> dict[str, torch.Tensor]:
    """The lag and assembly kernels' int32 tables from ``lag_plan(p)``, on
    ``device`` (the wide Gram's at p > 3, the 3x3 Gram's at p = 3):
    lag_index -- per (dc + 2h) * (2h + 1) + dr, the lag's index (-1 where
                 the lag is not canonical);
    lags       -- (dr, dc) per lag;
    pair_start -- the pairs of lag l are pairs[pair_start[l]:pair_start[l+1]];
    pairs      -- (row, column, ar, ai) per pair, grouped by lag."""
    h = p // 2
    lags, pair_lag, pair_ar, pair_ai, _ = lag_plan(p)
    lag_index = [-1] * ((4 * h + 1) * (2 * h + 1))
    for index, (dr, dc) in enumerate(lags):
        lag_index[(dc + 2 * h) * (2 * h + 1) + dr] = index
    n = p * p
    cells = [(a, c) for a in range(n) for c in range(a, n)]  # plan order
    order = sorted(range(len(cells)), key=lambda i: pair_lag[i])
    pairs = [(*cells[i], pair_ar[i], pair_ai[i]) for i in order]
    counts = [0] * (len(lags) + 1)
    for lag in pair_lag:
        counts[lag + 1] += 1
    pair_start = list(itertools.accumulate(counts))
    tables = {"lag_index": lag_index, "lags": lags,
              "pair_start": pair_start, "pairs": pairs}
    return {name: torch.tensor(value, dtype=torch.int32, device=device)
            for name, value in tables.items()}


def wide_lag_strips(image: torch.Tensor, p: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, H, W) f32 -> (sums (B, L, S, NB), edges (B, L, S, 4h)) over
    the strips and lane blocks of ``ops.me.wide_lag_layout``.

    CPU tensors take ``lag_strips_plain``; CUDA tensors launch the lag
    kernel (rows, cols >= 6h), one count in ``wide_lag_strips.launches``
    a call.
    """
    _check_p(p)
    if image.device.type == "cpu":
        return lag_strips_plain(image, p)
    _check_image(image, p)
    batch, rows, cols = image.shape
    h = p // 2
    strip, n_strips, n_blocks = wide_lag_layout(rows, cols, p)
    n_lags = len(lag_plan(p)[0])
    sums = torch.empty((batch, n_lags, n_strips, n_blocks),
                       dtype=torch.float32, device=image.device)
    edges = torch.empty((batch, n_lags, n_strips, 4 * h),
                        dtype=torch.float32, device=image.device)
    build.launch("wm_wide_lag_strips", image.device, image.data_ptr(),
                 _tables(p, image.device)["lag_index"].data_ptr(),
                 sums.data_ptr(), edges.data_ptr(), batch, rows, cols, h,
                 strip, LANE_BLOCK, n_lags)
    wide_lag_strips.launches += 1
    return sums, edges


def wide_assemble(sums: torch.Tensor, edges: torch.Tensor,
                  image: torch.Tensor, p: int) -> torch.Tensor:
    """The lag kernel's (sums, edges) of the (B, H, W) image
    -> (B, k+1, k+1) Gram.

    CPU tensors take ``assemble_strips_plain``; CUDA tensors launch the
    assembly kernel (rows, cols >= 6h), one count in
    ``wide_assemble.launches`` a call.
    """
    _check_p(p)
    if image.device.type == "cpu":
        return assemble_strips_plain(sums, edges, image, p)
    _check_image(image, p)
    batch, rows, cols = image.shape
    h = p // 2
    if sums.ndim != 4:
        raise ValueError(f"sums must be (B, L, S, NB), got "
                         f"{tuple(sums.shape)}")
    n_lags = len(lag_plan(p)[0])
    n_strips, n_blocks = sums.shape[2:]
    build.check_input("sums", sums, (batch, n_lags, n_strips, n_blocks),
                      image.device)
    build.check_input("edges", edges, (batch, n_lags, n_strips, 4 * h),
                      image.device)
    tables = _tables(p, image.device)
    gram = torch.empty((batch, p * p, p * p), dtype=torch.float32,
                       device=image.device)
    build.launch("wm_wide_assemble", image.device, image.data_ptr(),
                 sums.data_ptr(), edges.data_ptr(),
                 tables["lags"].data_ptr(), tables["pair_start"].data_ptr(),
                 tables["pairs"].data_ptr(), gram.data_ptr(), batch, rows,
                 cols, h, n_lags, n_strips, n_blocks)
    wide_assemble.launches += 1
    return gram


wide_lag_strips.launches = 0
wide_assemble.launches = 0


def me_gram_wide(image: torch.Tensor, p: int) -> torch.Tensor:
    """(B, H, W) f32 -> (B, k+1, k+1) Gram, k = p*p - 1, p in {5, 7, 9}.

    At rows, cols >= 6h: the lag kernel then the assembly kernel on CUDA
    tensors (so each of their counts takes one a Gram), their plain
    versions on CPU tensors. Below that geometry the direct per-pair sums,
    as the JAX package routes such frames to its XLA formulation.
    """
    _check_p(p)
    if not wide_lag_geometry(*image.shape[-2:], p):
        return gram_direct(image, p)
    return wide_assemble(*wide_lag_strips(image, p), image, p)
