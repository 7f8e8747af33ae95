"""Watermark matrix (.dat) file IO and generation.

File format (reference ``Watermark_GPU/Watermark.cpp:62-75``):
raw little-endian float32, row-major ``rows x cols``, no header. The loader
validates ``rows * cols * 4 == filesize`` exactly like the reference
(``Watermark.cpp:70-71``).

Generation (reference ``CommonRandomMatrix/main.cpp:16-68``):
N(0, 1) float32 stream from ``std::mt19937(seed)`` + ``normal_distribution``.
The reference has a quirk: every OpenMP thread seeds with the *same* seed
(``CommonRandomMatrix/main.cpp:41``), so its output is ~numThreads repetitions
of one stream prefix. ``generate_watermark(..., repeat_blocks=N)`` reproduces
that structure on request; the default is a single clean stream.

Bit-exactness with MSVC's ``std::normal_distribution`` is not reproducible (the
C++ standard does not pin the algorithm), and is not required: the watermark is
a data *input* — tests use the bundled ``.dat`` fixtures for parity.
"""

from __future__ import annotations

import os

import numpy as np


class WatermarkFileError(ValueError):
    """Raised when a .dat file does not match the expected dimensions."""


def load_watermark(path: str | os.PathLike, rows: int, cols: int) -> np.ndarray:
    """Load a rows x cols float32 watermark matrix, validating the file size."""
    total_bytes = os.path.getsize(path)
    expected = rows * cols * 4
    if total_bytes != expected:
        raise WatermarkFileError(
            f"Error: W file total elements != image dimensions! "
            f"W file total elements: {total_bytes // 4}, "
            f"Image width: {cols}, Image height: {rows}")
    data = np.fromfile(path, dtype="<f4", count=rows * cols)
    return np.ascontiguousarray(data.reshape(rows, cols))


def save_watermark(path: str | os.PathLike, matrix: np.ndarray) -> None:
    """Write a float32 matrix in the raw row-major .dat format."""
    np.asarray(matrix, dtype="<f4").tofile(path)


def generate_watermark(rows: int, cols: int, seed: int,
                       repeat_blocks: int = 1) -> np.ndarray:
    """Generate a rows x cols N(0,1) float32 watermark matrix.

    ``repeat_blocks > 1`` emulates the reference generator's same-seed-per-
    thread quirk: the matrix is split into that many contiguous chunks, each
    filled from the start of an identical stream.
    """
    if not (0 < rows < 32768 and 0 < cols < 32768):
        raise ValueError(
            "Rows and columns must be positive integers less than 32768.")
    n = rows * cols
    rng = np.random.Generator(np.random.MT19937(seed))
    if repeat_blocks <= 1:
        values = rng.standard_normal(n, dtype=np.float32)
    else:
        chunk = -(-n // repeat_blocks)
        stream = rng.standard_normal(chunk, dtype=np.float32)
        pieces = []
        remaining = n
        for i in range(repeat_blocks):
            size = chunk if i < repeat_blocks - 1 else remaining
            pieces.append(stream[:size])
            remaining -= size
        values = np.concatenate(pieces)
    return values.reshape(rows, cols)
