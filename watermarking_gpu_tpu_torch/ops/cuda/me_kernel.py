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
"""

from __future__ import annotations

import torch

from ..me import (GRAM_BLOCK_COLS, assemble_lags_plain, gram_direct,
                  gram_lag_layout, gram_lags_plain, lag_plan)
from . import build
from .me_gram_wide import _tables

N_LAGS = len(lag_plan(3)[0])


def me_gram_plain(image: torch.Tensor) -> torch.Tensor:
    """(B, H, W) -> (B, 9, 9) Gram from the elementwise oracle."""
    return gram_direct(image, 3)


def _check_image(image: torch.Tensor) -> None:
    if image.device.type != "cuda" or image.ndim != 3:
        raise ValueError(f"me_gram takes a (B, H, W) CUDA or CPU tensor, got "
                         f"{tuple(image.shape)} on {image.device}")
    build.check_input("image", image, tuple(image.shape), image.device)


def _launch_lags(image: torch.Tensor) -> torch.Tensor:
    """The lag kernel on a checked CUDA image; counts the launch."""
    batch, rows, cols = image.shape
    strip, n_strips, n_blocks = gram_lag_layout(rows, cols)
    sums = torch.empty((batch, N_LAGS, n_strips, n_blocks),
                       dtype=torch.float32, device=image.device)
    build.launch("wm_me_gram_lags", image.device, image.data_ptr(),
                 _tables(3, image.device)["lag_index"].data_ptr(),
                 sums.data_ptr(), batch, rows, cols, strip, GRAM_BLOCK_COLS)
    me_gram_lags.launches += 1
    return sums


def _launch_assemble(sums: torch.Tensor,
                     image: torch.Tensor) -> torch.Tensor:
    """The assembly kernel on checked CUDA sums and image; counts the
    launch."""
    batch, rows, cols = image.shape
    tables = _tables(3, image.device)
    gram = torch.empty((batch, 9, 9), dtype=torch.float32,
                       device=image.device)
    build.launch("wm_me_gram_assemble", image.device, image.data_ptr(),
                 sums.data_ptr(), tables["lags"].data_ptr(),
                 tables["pair_start"].data_ptr(), tables["pairs"].data_ptr(),
                 gram.data_ptr(), batch, rows, cols,
                 sums.shape[2] * sums.shape[3])
    me_gram_assemble.launches += 1
    return gram


def me_gram_lags(image: torch.Tensor) -> torch.Tensor:
    """(B, H, W) f32 -> (B, 13, S, NB) lag sums over the strips and column
    blocks of ``ops.me.gram_lag_layout``.

    CPU tensors take ``gram_lags_plain``; CUDA tensors launch the lag
    kernel, one count in ``me_gram_lags.launches`` a call.
    """
    if image.device.type == "cpu":
        return gram_lags_plain(image)
    _check_image(image)
    return _launch_lags(image)


def me_gram_assemble(sums: torch.Tensor, image: torch.Tensor) -> torch.Tensor:
    """The lag kernel's (B, 13, S, NB) sums of the (B, H, W) image
    -> (B, 9, 9) Gram.

    CPU tensors take ``assemble_lags_plain``; CUDA tensors launch the
    assembly kernel (it may start before the lag kernel that wrote the sums
    ends: a programmatic dependent launch), one count in
    ``me_gram_assemble.launches`` a call.
    """
    if image.device.type == "cpu":
        return assemble_lags_plain(sums, image)
    _check_image(image)
    if sums.ndim != 4:
        raise ValueError(f"sums must be (B, 13, S, NB), got "
                         f"{tuple(sums.shape)}")
    build.check_input("sums", sums, (image.shape[0], N_LAGS,
                                     *sums.shape[2:]), image.device)
    return _launch_assemble(sums, image)


me_gram_lags.launches = 0
me_gram_assemble.launches = 0


def me_gram(image: torch.Tensor) -> torch.Tensor:
    """(B, H, W) f32 -> (B, 9, 9) Gram.

    CPU tensors take ``me_gram_plain``; CUDA tensors the lag kernel then the
    assembly kernel (so each of their counts takes one a Gram), the image
    checked once.
    """
    if image.device.type == "cpu":
        return me_gram_plain(image)
    _check_image(image)
    return _launch_assemble(_launch_lags(image), image)
