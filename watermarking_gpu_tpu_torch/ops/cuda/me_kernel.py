"""The 3x3 ME Gram: the (B, 9, 9) Gram of [8 clamped neighbors; center]
from two kernels (``csrc/me_gram.cu``). ``G[:, :8, :8]`` is Rx and
``G[:, :8, 8]`` is rx. Counterpart of the JAX package's
``ops/pallas/me_kernel.py`` (the lag kernel and ``_assemble_gram``).

1. The lag kernel (``me_gram_lags``) sums each of the 13 lag products over
   the frame's own columns, per strip of rows and block of columns
   (``ops.me.gram_lag_layout``). Its plain version is
   ``ops.me.gram_lags_plain``.
2. The assembly kernel (``me_gram_assemble``) adds those up, takes the
   column windows and the boundary-row corrections from the image and
   writes the Gram. Its plain version is ``ops.me.assemble_lags_plain``.

On CPU tensors ``me_gram`` takes ``me_gram_plain``, the direct per-pair
sums. Every frame of at least one pixel takes the kernels on the card.

Halo form (a row shard, ``parallel/spatial.py``; the JAX package's
``me_gram_padded`` with exchanged rows spliced into its padding): the image
is (B, top + H + bottom, W), H owned rows with ``top`` rows above and
``bottom`` below (true rows at a seam, replicated edge rows at the
frame's border); the Gram sums the owned rows' centres, their neighbours
read from those rows (clamped to them), so the shards' Grams add up to the
frame's. A seam needs one row of halo (the lag kernel's bottom row of
dr = 2 past it is read by the lag sums and cancelled by the assembly, as
at the frame's edge), so the wrappers take the shard's first row in the
frame, ``row_start``, and the frame's ``total_rows``, and raise at a seam
with no halo row. ``top = bottom = 0`` is the frame itself.
"""

from __future__ import annotations

import torch

from ..me import (GRAM_BLOCK_COLS, assemble_lags_plain, gram_direct,
                  gram_lag_layout, gram_lags_plain, lag_plan)
from . import build
from .fused import check_halo
from .me_gram_wide import _tables

N_LAGS = len(lag_plan(3)[0])


def me_gram_plain(image: torch.Tensor, top: int = 0,
                  bottom: int = 0) -> torch.Tensor:
    """(B, H, W) -> (B, 9, 9) Gram from the elementwise oracle (the halo
    form: of a (B, top + H + bottom, W) shard's owned rows)."""
    return gram_direct(image, 3, top, bottom)


def _check_image(image: torch.Tensor, top: int, bottom: int,
                 row_start: int, total_rows: int | None) -> int:
    """Raise on what the kernels (or, on the CPU, the plain halo forms) do
    not take; returns the owned rows."""
    rows = check_halo(image, top, bottom, 1, row_start, total_rows,
                      "the 3x3 Gram")[0]
    if image.device.type == "cpu":
        return rows
    if image.device.type != "cuda" or image.ndim != 3:
        raise ValueError(f"me_gram takes a (B, H, W) CUDA or CPU tensor, got "
                         f"{tuple(image.shape)} on {image.device}")
    build.check_input("image", image, tuple(image.shape), image.device)
    return rows


def _launch_lags(image: torch.Tensor, rows: int, top: int,
                 bottom: int) -> torch.Tensor:
    """The lag kernel on a checked CUDA image; counts the launch."""
    batch, _, cols = image.shape
    strip, n_strips, n_blocks = gram_lag_layout(rows, cols)
    sums = torch.empty((batch, N_LAGS, n_strips, n_blocks),
                       dtype=torch.float32, device=image.device)
    build.launch("wm_me_gram_lags", image.device, image.data_ptr(),
                 _tables(3, image.device)["lag_index"].data_ptr(),
                 sums.data_ptr(), batch, rows, cols, strip, GRAM_BLOCK_COLS,
                 top, bottom)
    me_gram_lags.launches += 1
    return sums


def _launch_assemble(sums: torch.Tensor, image: torch.Tensor, rows: int,
                     top: int, bottom: int) -> torch.Tensor:
    """The assembly kernel on checked CUDA sums and image; counts the
    launch."""
    batch, _, cols = image.shape
    tables = _tables(3, image.device)
    gram = torch.empty((batch, 9, 9), dtype=torch.float32,
                       device=image.device)
    build.launch("wm_me_gram_assemble", image.device, image.data_ptr(),
                 sums.data_ptr(), tables["lags"].data_ptr(),
                 tables["pair_start"].data_ptr(), tables["pairs"].data_ptr(),
                 gram.data_ptr(), batch, rows, cols,
                 sums.shape[2] * sums.shape[3], top, bottom)
    me_gram_assemble.launches += 1
    return gram


def me_gram_lags(image: torch.Tensor, top: int = 0, bottom: int = 0,
                 row_start: int = 0,
                 total_rows: int | None = None) -> torch.Tensor:
    """(B, H, W) f32 -> (B, 13, S, NB) lag sums over the strips and column
    blocks of ``ops.me.gram_lag_layout`` (the halo form: of a (B, top + H +
    bottom, W) shard's owned rows, rows [row_start, row_start + H) of a
    frame of ``total_rows``).

    CPU tensors take ``gram_lags_plain``; CUDA tensors launch the lag
    kernel, one count in ``me_gram_lags.launches`` a call.
    """
    rows = _check_image(image, top, bottom, row_start, total_rows)
    if image.device.type == "cpu":
        return gram_lags_plain(image, top, bottom)
    return _launch_lags(image, rows, top, bottom)


def me_gram_assemble(sums: torch.Tensor, image: torch.Tensor, top: int = 0,
                     bottom: int = 0, row_start: int = 0,
                     total_rows: int | None = None) -> torch.Tensor:
    """The lag kernel's (B, 13, S, NB) sums of the (B, H, W) image
    -> (B, 9, 9) Gram (the halo form: of a (B, top + H + bottom, W) shard,
    as in ``me_gram_lags``).

    CPU tensors take ``assemble_lags_plain``; CUDA tensors launch the
    assembly kernel (it may start before the lag kernel that wrote the sums
    ends: a programmatic dependent launch), one count in
    ``me_gram_assemble.launches`` a call.
    """
    rows = _check_image(image, top, bottom, row_start, total_rows)
    if image.device.type == "cpu":
        return assemble_lags_plain(sums, image, top, bottom)
    if sums.ndim != 4:
        raise ValueError(f"sums must be (B, 13, S, NB), got "
                         f"{tuple(sums.shape)}")
    build.check_input("sums", sums, (image.shape[0], N_LAGS,
                                     *sums.shape[2:]), image.device)
    return _launch_assemble(sums, image, rows, top, bottom)


me_gram_lags.launches = 0
me_gram_assemble.launches = 0


def me_gram(image: torch.Tensor, top: int = 0, bottom: int = 0,
            row_start: int = 0, total_rows: int | None = None
            ) -> torch.Tensor:
    """(B, H, W) f32 -> (B, 9, 9) Gram (the halo form: of a (B, top + H +
    bottom, W) shard's owned rows, as in ``me_gram_lags``).

    CPU tensors take ``me_gram_plain``; CUDA tensors the lag kernel then the
    assembly kernel (so each of their counts takes one a Gram), the image
    checked once.
    """
    rows = _check_image(image, top, bottom, row_start, total_rows)
    if image.device.type == "cpu":
        return me_gram_plain(image, top, bottom)
    return _launch_assemble(_launch_lags(image, rows, top, bottom), image,
                            rows, top, bottom)
