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
   windows, computes the boundary-row corrections from the frame's two
   banks of 4h rows (``ops.me.frame_banks``) and writes the Gram. Its plain
   version is ``ops.me.assemble_strips_plain``.

On CPU tensors ``me_gram_wide`` chains the two plain versions. The lag form
needs rows, cols >= 6h (the JAX package's own rule,
``ops.me.wide_lag_geometry``); smaller frames take the direct per-pair sums
(``ops.me.gram_direct``) on any device.

Halo form (a row shard, ``parallel/spatial.py``; the JAX package's
``_gram_wide_sharded`` with ``impl="pallas"``): the lag kernel takes a
(B, top + H + bottom, W) shard, H owned rows with ``top`` rows above and
``bottom`` below (true neighbour rows at a seam, replicated edge rows at
the frame's border), and sums the owned rows only, reading their lags'
rows below them; a lag reaches 2h rows down, so a seam needs 2h rows of
halo below, and the wrapper takes the shard's first row in the frame,
``row_start``, and the frame's ``total_rows`` to tell a seam from the
frame's edge. The shards' outputs add up to the frame's. The assembly takes
the frame's banks, which the first and last shard hold, and its
``total_rows``. ``top = bottom = 0`` is the frame itself.
"""

from __future__ import annotations

import functools
import itertools

import torch

from ...utils.profiling import begin
from ..me import (LANE_BLOCK, assemble_strips_plain, frame_banks,
                  gram_direct, lag_plan, lag_strips_plain, wide_lag_geometry,
                  wide_lag_layout)
from . import build
from .fused import check_halo

WIDE_P = (5, 7, 9)


def _check_p(p: int) -> None:
    if p not in WIDE_P:
        raise ValueError(f"the wide Gram takes p in {WIDE_P}, got {p}")


def _check_image(image: torch.Tensor, p: int, top: int = 0,
                 bottom: int = 0, row_start: int = 0,
                 total_rows: int | None = None) -> tuple[int, int]:
    """Raise on what the lag kernel (or, on the CPU, its plain halo form)
    does not take; returns (owned rows, total_rows)."""
    h = p // 2
    rows, total_rows = check_halo(image, top, bottom, 2 * h, row_start,
                                  total_rows, "the wide Gram's lag kernel",
                                  reach_top=0)
    if not wide_lag_geometry(total_rows, image.shape[-1], p):
        raise ValueError(f"the wide Gram kernels need a frame of rows, cols "
                         f">= {6 * h} at p={p}, got {total_rows} rows of "
                         f"{image.shape[-1]} columns")
    if image.device.type == "cpu":
        return rows, total_rows
    if image.device.type != "cuda" or image.ndim != 3:
        raise ValueError(f"me_gram_wide takes a (B, H, W) CUDA or CPU "
                         f"tensor, got {tuple(image.shape)} on "
                         f"{image.device}")
    build.check_input("image", image, tuple(image.shape), image.device)
    return rows, total_rows


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


def _launch_lags(image: torch.Tensor, p: int, rows: int, top: int,
                 bottom: int, total_rows: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The lag kernel on a checked CUDA image; counts the launch."""
    batch, _, cols = image.shape
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
                 strip, LANE_BLOCK, n_lags, top, bottom, total_rows)
    wide_lag_strips.launches += 1
    return sums, edges


def _launch_assemble(sums: torch.Tensor, edges: torch.Tensor,
                     low: torch.Tensor, high: torch.Tensor, p: int,
                     total_rows: int) -> torch.Tensor:
    """The assembly kernel on checked CUDA sums, edges and banks (low and
    high with one batch stride, each image's rows contiguous); counts the
    launch."""
    batch, _, cols = low.shape
    n_strips, n_blocks = sums.shape[2:]
    tables = _tables(p, low.device)
    gram = torch.empty((batch, p * p, p * p), dtype=torch.float32,
                       device=low.device)
    build.launch("wm_wide_assemble", low.device, low.data_ptr(),
                 high.data_ptr(), low.stride(0), sums.data_ptr(),
                 edges.data_ptr(), tables["lags"].data_ptr(),
                 tables["pair_start"].data_ptr(), tables["pairs"].data_ptr(),
                 gram.data_ptr(), batch, cols, p // 2, len(lag_plan(p)[0]),
                 n_strips, n_blocks, total_rows)
    wide_assemble.launches += 1
    return gram


def wide_lag_strips(image: torch.Tensor, p: int, top: int = 0,
                    bottom: int = 0, row_start: int = 0,
                    total_rows: int | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, H, W) f32 -> (sums (B, L, S, NB), edges (B, L, S, 4h)) over
    the strips and lane blocks of ``ops.me.wide_lag_layout``; the halo form
    takes a (B, top + H + bottom, W) shard and sums its owned rows (module
    docstring).

    CPU tensors take ``lag_strips_plain``; CUDA tensors launch the lag
    kernel (a frame of rows, cols >= 6h), one count in
    ``wide_lag_strips.launches`` a call.
    """
    span = begin("kernels.wide_lag_strips")
    try:
        _check_p(p)
        rows, total_rows = _check_image(image, p, top, bottom, row_start,
                                        total_rows)
        if image.device.type == "cpu":
            return lag_strips_plain(image, p, top, bottom)
        return _launch_lags(image, p, rows, top, bottom, total_rows)
    finally:
        if span:
            span.end()


def _check_banks(low: torch.Tensor, high: torch.Tensor, p: int) -> None:
    """Raise unless low and high are (B, 4h, W) f32 banks on one CUDA
    device, each image's rows contiguous and the two with one batch
    stride."""
    h = p // 2
    if low.device.type != "cuda" or low.ndim != 3:
        raise ValueError(f"wide_assemble takes (B, 4h, W) CUDA or CPU "
                         f"banks, got {tuple(low.shape)} on {low.device}")
    shape = (low.shape[0], 4 * h, low.shape[2])
    for name, bank in (("low", low), ("high", high)):
        if bank.device != low.device or bank.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 on {low.device}, got "
                             f"{bank.dtype} on {bank.device}")
        if tuple(bank.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(bank.shape)}")
        if bank.stride()[1:] != (shape[2], 1):
            raise ValueError(f"{name}'s rows must be contiguous")
    if low.stride(0) != high.stride(0):
        raise ValueError(f"low and high must share a batch stride, got "
                         f"{low.stride(0)} and {high.stride(0)}")


def wide_assemble(sums: torch.Tensor, edges: torch.Tensor, low: torch.Tensor,
                  high: torch.Tensor, p: int, total_rows: int) -> torch.Tensor:
    """The lag kernel's (sums, edges) over a frame's rows (any strips and
    lane blocks: a row shard's, folded) and the frame's (B, 4h, W) banks
    (``ops.me.frame_banks``: rows [-h, 3h) and [H - h, H + 3h), clamped)
    -> (B, k+1, k+1) Gram; ``total_rows`` is the frame's H.

    CPU tensors take ``assemble_strips_plain``; CUDA tensors launch the
    assembly kernel (the banks' rows contiguous, both with one batch
    stride), one count in ``wide_assemble.launches`` a call.
    """
    span = begin("kernels.wide_assemble")
    try:
        _check_p(p)
        h = p // 2
        if not wide_lag_geometry(total_rows, low.shape[-1], p):
            raise ValueError(
                f"the wide Gram kernels need a frame of rows, cols >= "
                f"{6 * h} at p={p}, got {total_rows} rows of "
                f"{low.shape[-1]} columns")
        if low.device.type == "cpu":
            return assemble_strips_plain(sums, edges, low, high, p)
        _check_banks(low, high, p)
        if sums.ndim != 4:
            raise ValueError(f"sums must be (B, L, S, NB), got "
                             f"{tuple(sums.shape)}")
        shape = (low.shape[0], len(lag_plan(p)[0]), *sums.shape[2:])
        build.check_input("sums", sums, shape, low.device)
        build.check_input("edges", edges, (*shape[:3], 4 * h), low.device)
        return _launch_assemble(sums, edges, low, high, p, total_rows)
    finally:
        if span:
            span.end()


wide_lag_strips.launches = 0
wide_assemble.launches = 0


def me_gram_wide(image: torch.Tensor, p: int) -> torch.Tensor:
    """(B, H, W) f32 -> (B, k+1, k+1) Gram, k = p*p - 1, p in {5, 7, 9}.

    At rows, cols >= 6h: the lag kernel then the assembly kernel on CUDA
    tensors (so each of their counts takes one a Gram; the image checked
    once), their plain versions on CPU tensors. Below that geometry the
    direct per-pair sums, as the JAX package routes such frames to its XLA
    formulation.
    """
    span = begin("kernels.me_gram_wide")
    try:
        _check_p(p)
        rows, cols = image.shape[-2:]
        if not wide_lag_geometry(rows, cols, p):
            return gram_direct(image, p)
        _check_image(image, p)
        if image.device.type == "cpu":
            return assemble_strips_plain(*lag_strips_plain(image, p),
                                         *frame_banks(image, p), p)
        return _launch_assemble(*_launch_lags(image, p, rows, 0, 0, rows),
                                *frame_banks(image, p), p, rows)
    finally:
        if span:
            span.end()
