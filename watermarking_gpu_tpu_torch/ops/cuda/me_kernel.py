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

``me_gram_solve8`` is the Gram with the 3x3 predictor's solve folded in:
the assembly kernel's last block of each frame solves that frame's 8x8
system right after its Gram is complete (``csrc/spd_solve8.cuh``, the
function ``spd_solve8``'s kernel runs), so a single device's analysis is
two launches and one wrapper call, with ``spd_solve8(me_gram(x))``'s bits.
The JAX package's jitted step fuses its solve into the XLA code after the
Gram the same way. Whole frames only: the halo form's Grams are folded
across shards before their solve (``parallel/spatial.py``).

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
from .solve import spd_solve8_plain

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


def _lags_call(image: torch.Tensor, rows: int, top: int, bottom: int,
               sums: int, done: int | None = None) -> tuple[str, tuple]:
    """The lag kernel's C entry and arguments for a checked CUDA image,
    its sums at address ``sums`` (``build.launch_many``)."""
    batch, _, cols = image.shape
    return ("wm_me_gram_lags", (
        image.data_ptr(), _tables(3, image.device)["lag_index"].data_ptr(),
        sums, batch, rows, cols, gram_lag_layout(rows, cols)[0],
        GRAM_BLOCK_COLS, top, bottom, done))


def _assemble_call(image: torch.Tensor, rows: int, top: int, bottom: int,
                   sums: int, n_parts: int, gram: int,
                   solve: tuple = (None, None, None)) -> tuple[str, tuple]:
    """The assembly kernel's C entry and arguments: the Gram at address
    ``gram`` from the lag sums at ``sums``, and with ``solve`` =
    (coefficients, valid, done) addresses each frame's solve too."""
    batch, _, cols = image.shape
    tables = _tables(3, image.device)
    return ("wm_me_gram_assemble", (
        image.data_ptr(), sums, tables["lags"].data_ptr(),
        tables["pair_start"].data_ptr(), tables["pairs"].data_ptr(), gram,
        batch, rows, cols, n_parts, top, bottom, *solve))


def _launch_lags(image: torch.Tensor, rows: int, top: int,
                 bottom: int) -> torch.Tensor:
    """The lag kernel on a checked CUDA image; counts the launch."""
    batch, _, cols = image.shape
    _, n_strips, n_blocks = gram_lag_layout(rows, cols)
    sums = torch.empty((batch, N_LAGS, n_strips, n_blocks),
                       dtype=torch.float32, device=image.device)
    build.launch_many(image.device, _lags_call(image, rows, top, bottom,
                                               sums.data_ptr()))
    me_gram_lags.launches += 1
    return sums


def _launch_assemble(sums: torch.Tensor, image: torch.Tensor, rows: int,
                     top: int, bottom: int) -> torch.Tensor:
    """The assembly kernel on checked CUDA sums and image; counts the
    launch."""
    gram = torch.empty((image.shape[0], 9, 9), dtype=torch.float32,
                       device=image.device)
    build.launch_many(image.device, _assemble_call(
        image, rows, top, bottom, sums.data_ptr(),
        sums.shape[2] * sums.shape[3], gram.data_ptr()))
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


def me_gram_solve8(image: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, H, W) f32 frames -> ((B, 9, 9) Gram, (B, 8) coefficients, (B,)
    bool valid): ``me_gram`` and ``spd_solve8`` of its Gram in one call,
    valid False (coefficients zeros) where a coefficient is not finite.

    CPU tensors take ``me_gram_plain`` then ``spd_solve8_plain``; CUDA
    tensors launch the lag kernel and the solving assembly kernel (one
    count each in ``me_gram_lags.launches`` and
    ``me_gram_assemble.launches``, and one in ``me_gram_solve8.launches``,
    a call); another device or shape raises ``ValueError``.
    """
    if image.ndim != 3:
        raise ValueError(f"me_gram_solve8 takes (B, H, W) frames, got "
                         f"{tuple(image.shape)}")
    rows = _check_image(image, 0, 0, 0, None)
    if image.device.type == "cpu":
        gram = me_gram_plain(image)
        return (gram, *spd_solve8_plain(gram))
    batch, _, cols = image.shape
    _, n_strips, n_blocks = gram_lag_layout(rows, cols)
    # one f32 allocation from the caching allocator on the current stream:
    # the coefficients (first, at the allocation's alignment), the Gram,
    # the call's own count of finished assembly blocks a frame (int32;
    # services on other streams of the card have theirs) and the lag sums
    buffer = torch.empty(batch * (90 + N_LAGS * n_strips * n_blocks),
                         dtype=torch.float32, device=image.device)
    coefficients = buffer[:8 * batch].view(batch, 8)
    gram = buffer[8 * batch:89 * batch].view(batch, 9, 9)
    valid = torch.empty(batch, dtype=torch.bool, device=image.device)
    done = buffer.data_ptr() + 4 * 89 * batch
    sums = done + 4 * batch
    build.launch_many(
        image.device, _lags_call(image, rows, 0, 0, sums, done),
        _assemble_call(image, rows, 0, 0, sums, n_strips * n_blocks,
                       gram.data_ptr(), (coefficients.data_ptr(),
                                         valid.data_ptr(), done)))
    me_gram_lags.launches += 1
    me_gram_assemble.launches += 1
    me_gram_solve8.launches += 1
    return gram, coefficients, valid


me_gram_solve8.launches = 0
