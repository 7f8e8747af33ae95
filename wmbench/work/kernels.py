"""Least time of one kernel call, frozen from ``chip_smoke.py``.

``bound``, ``cholesky_ops`` and ``kernel_bound`` as ``chip_smoke.py`` had
them when the benchmark was defined, with the frame geometry and the bank
size as arguments instead of module constants. They give PERF.md §6's
"bound ms" column; the operation counts in ``work/step.py`` and
``work/identify.py`` are the benchmark's yardstick, these are the per-kernel
one that a per-kernel roofline reads.
"""

from __future__ import annotations

from .peaks import F32_FLOPS_PER_S, HBM_BYTES_PER_S

# the operations of an 8-unknown Cholesky solve (cholesky_ops(8))
SOLVE_OPS = 248 + 2 * 72


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """(least ms, what binds it) for moving ``nbytes`` and doing ``flops``
    on an H100 SXM at its data-sheet peaks."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / F32_FLOPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def cholesky_ops(n: int) -> int:
    """Operations of an n-unknown Cholesky solve: per column j of the factor
    j products and sums, a subtraction, a square root and a reciprocal, and
    per entry below it j products and sums, a subtraction and a product; per
    row of each substitution i products and sums, a subtraction and a
    division."""
    factor = sum(2 * j + 3 + (n - 1 - j) * (2 * j + 2) for j in range(n))
    return factor + 2 * sum(2 * i + 2 for i in range(n))


def kernel_bound(kernel: str, mask: str, p: int, batch: int = 8,
                 rows: int = 1080, cols: int = 1920, candidates: int = 64,
                 channels: int = 1, itemsize: int = 4) -> tuple[float, str]:
    """The bound of one kernel call on ``batch`` frames of rows x cols: each
    input read once, each output written once, and the flops the function
    needs, per pixel (a multiply-add counts 2; the detect tail's ring is
    not counted):

    * the 3x3 Gram: 13 lag products;
    * the wide Gram: one product per canonical lag and lane of each row;
    * the NVF mask: separable p x p box sums of x and x^2 (4(p-1) adds), one
      square, and 6 for the mean, E[x^2], the variance and var/(1+var);
    * a (p*p-1)-tap prediction error: a product and a subtraction a tap;
    * the multi-candidate detect: the frames and the bank read once each,
      two sums per frame and candidate written; per frame, candidate and
      pixel u = mask * W_c, e_u and the two sums (2k + 5 flops, k taps), and
      per frame and pixel e_z, the mask and e_z^2;
    * the 8x8 solve: Rx's lower triangle (36) and rx (8) read, 8
      coefficients and a valid byte written; SOLVE_OPS operations a system;
    * the 3x3 Gram with the solve in its assembly: the Gram's frames read,
      its Gram, 8 coefficients and a valid byte written a frame;
    * the wide solve: likewise with k unknowns, ``cholesky_ops(k)``;
    * the embed finish: u_raw read, the output read and the marked frames
      written, four scalars a frame; a product, a sum and the clamp's two
      comparisons an element.
    """
    pixels = batch * rows * cols
    frame_bytes = 4 * pixels                            # read
    out_bytes = 4 * pixels                              # written
    wm_bytes = 4 * rows * cols
    k = p * p - 1
    nvf_flops = 4 * (p - 1) + 1 + 6
    if kernel == "me_gram":
        return bound(frame_bytes + 4 * batch * 81, 2 * 13 * pixels)
    if kernel == "embed_finish":
        elems = pixels * channels
        return bound(4 * pixels + 2 * itemsize * elems + 13 * batch,
                     4 * elems)
    if kernel == "spd_solve8":
        return bound(batch * (4 * (36 + 8) + 4 * 8 + 1), batch * SOLVE_OPS)
    if kernel == "me_gram_solve8":
        return bound(frame_bytes + batch * (4 * 81 + 4 * 8 + 1),
                     2 * 13 * pixels + batch * SOLVE_OPS)
    if kernel == "spd_solve_wide":
        return bound(batch * (4 * (k * (k + 1) // 2 + k) + 4 * k + 1),
                     batch * cholesky_ops(k))
    if kernel == "me_gram_wide":
        h = p // 2
        lags = ((4 * h + 1) ** 2 + 1) // 2
        lanes = batch * lags * (cols + 2 * h)
        return bound(4 * pixels + 4 * lanes, 2 * lanes * rows)
    if kernel == "embed_field":
        mask_flops = 2 * k + 1 if mask == "me" else nvf_flops
        return bound(frame_bytes + out_bytes + wm_bytes + 8 * batch,
                     (mask_flops + 4) * pixels)    # u, u^2, max
    if kernel == "prediction_error":
        return bound(frame_bytes + out_bytes + 4 * batch * k,
                     2 * k * pixels)
    if kernel == "nvf_mask":
        return bound(frame_bytes + out_bytes, nvf_flops * pixels)
    taps = k if mask == "me" else 8
    mask_flops = 1 if mask == "me" else nvf_flops
    if kernel == "detect_many":
        bank_bytes = 4 * candidates * rows * cols
        return bound(frame_bytes + bank_bytes
                     + 4 * batch * (taps + 2 * candidates + 1),
                     ((2 * taps + 5) * candidates + 2 * taps + mask_flops
                      + 2) * pixels)
    if kernel == "detect_tail":
        return bound(frame_bytes + wm_bytes + 12 * batch,
                     (4 * taps + mask_flops + 7) * pixels)
    raise ValueError(f"no bound for kernel {kernel!r}")
