"""Prediction-error (ME) mask: normal equations, solve, prediction, mask.

Reference behavior:

* Over every pixel, accumulate the 8-neighbor outer products
  ``Rx = sum_p n(p) n(p)^T`` and the neighbor-center correlations
  ``rx = sum_p n(p) * center(p)`` (``kernels/me_p3.hpp:8-21,59-82``), then
  solve ``Rx a = rx`` (``Watermark.cpp:140-151,200-207``).
* Prediction ``x_hat = sum_k a_k * neighbor_k``; error ``e = image - x_hat``;
  mask ``|e| / max|e|`` (``Watermark.cpp:210-215``).
* An unsolvable system makes the reference skip embedding and report
  correlation 0 (``Watermark.cpp:202-207``). Here singularity surfaces as a
  per-image ``valid`` flag that callers apply with ``torch.where`` — no host
  sync, no exception.

Only the reference's p=3 predictor (8 taps) is ported; wider windows raise
``NotImplementedError``. All functions are batch-polymorphic over leading
dims: images (..., H, W), coefficients (..., 8), Rx (..., 8, 8), rx (..., 8).
"""

from __future__ import annotations

import torch

from .neighbors import pad_edge, shifted_views

SUPPORTED_P = (3,)


def require_supported_p(p: int) -> None:
    """Raise for predictor windows the port does not have yet."""
    if p not in SUPPORTED_P:
        raise NotImplementedError(
            f"p={p}: the PyTorch port implements p=3 only; the wide windows "
            "p in {5, 7, 9} are ROADMAP.md queue 1 item 9")


def me_normal_equations(image: torch.Tensor, p: int = 3
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Accumulate Rx (..., 8, 8) and rx (..., 8) over all pixels.

    Built from elementwise products and sums (full f32; no matmul, so no
    TF32 question arises on the card).
    """
    require_supported_p(p)
    rows, cols = image.shape[-2:]
    views = shifted_views(pad_edge(image, 1), rows, cols)
    k = len(views)
    rx_vector = torch.stack(
        [(view * image).sum(dim=(-2, -1)) for view in views], dim=-1)
    rx_matrix = image.new_empty(*image.shape[:-2], k, k)
    for i in range(k):
        for j in range(i, k):
            total = (views[i] * views[j]).sum(dim=(-2, -1))
            rx_matrix[..., i, j] = total
            rx_matrix[..., j, i] = total
    return rx_matrix, rx_vector


def _gate_finite(coefficients: torch.Tensor, valid: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fold non-finite solutions into ``valid`` and zero invalid rows, so
    downstream math stays finite."""
    valid = valid & torch.isfinite(coefficients).all(dim=-1)
    return (torch.where(valid[..., None], coefficients,
                        torch.zeros_like(coefficients)), valid)


def solve_coefficients(rx_matrix: torch.Tensor, rx_vector: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Solve Rx a = rx (batched LU). Returns (coefficients, valid).

    ``torch.linalg.solve`` raises on a singular matrix, so the factorization
    reports instead: ``valid`` is False where ``info`` flags a zero pivot,
    where the solution is not finite, or where the smallest pivot is below
    ``k * eps`` of the largest. The last catches systems that are singular
    in exact arithmetic but whose blocked f32 elimination leaves a rounding
    residue for a pivot (a constant frame's rank-1 Gram does that in MKL),
    where the "solution" means nothing.
    """
    lu, pivots, info = torch.linalg.lu_factor_ex(rx_matrix)
    solution = torch.linalg.lu_solve(lu, pivots, rx_vector[..., None])
    diag = lu.diagonal(dim1=-2, dim2=-1).abs()
    floor = rx_matrix.shape[-1] * torch.finfo(rx_matrix.dtype).eps
    well_posed = diag.amin(dim=-1) > floor * diag.amax(dim=-1)
    return _gate_finite(solution[..., 0], (info == 0) & well_posed)


def solve_coefficients_spd(rx_matrix: torch.Tensor, rx_vector: torch.Tensor
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Unrolled batched Cholesky solve for the SPD Gram system.

    The same scalar recurrence as the JAX package's solver, in (B,)-vector
    arithmetic. A zero or negative pivot gives Inf/NaN, which becomes
    ``valid=False`` (the reference's solve-failure contract).
    """
    n = rx_matrix.shape[-1]
    a = [[rx_matrix[..., i, j] for j in range(n)] for i in range(n)]
    lower: list[list] = [[None] * n for _ in range(n)]
    for j in range(n):
        diag = a[j][j] - sum((lower[j][k] * lower[j][k] for k in range(j)),
                             start=torch.zeros_like(a[j][j]))
        lower[j][j] = torch.sqrt(diag)
        inv_diag = 1.0 / lower[j][j]
        for i in range(j + 1, n):
            off = a[i][j] - sum((lower[i][k] * lower[j][k] for k in range(j)),
                                start=torch.zeros_like(a[i][j]))
            lower[i][j] = off * inv_diag
    # forward substitution L y = rx
    y = []
    for i in range(n):
        y.append((rx_vector[..., i]
                  - sum((lower[i][k] * y[k] for k in range(i)),
                        start=torch.zeros_like(rx_vector[..., i])))
                 / lower[i][i])
    # back substitution L^T x = y
    x: list = [None] * n
    for i in reversed(range(n)):
        x[i] = (y[i] - sum((lower[k][i] * x[k] for k in range(i + 1, n)),
                           start=torch.zeros_like(y[i]))) / lower[i][i]
    coefficients = torch.stack(x, dim=-1)
    return _gate_finite(coefficients, torch.ones_like(coefficients[..., 0],
                                                      dtype=torch.bool))


def prediction_error(image: torch.Tensor, coefficients: torch.Tensor,
                     p: int = 3) -> torch.Tensor:
    """Error sequence e = image - sum_k c_k * neighbor_k (clamped), with the
    taps subtracted in coefficient order (the order the kernels use)."""
    require_supported_p(p)
    rows, cols = image.shape[-2:]
    error = image
    for k, view in enumerate(shifted_views(pad_edge(image, 1), rows, cols)):
        error = error - coefficients[..., k, None, None] * view
    return error


def predict(image: torch.Tensor, coefficients: torch.Tensor,
            p: int = 3) -> torch.Tensor:
    """8-tap linear prediction of each pixel from its clamped neighbors."""
    return image - prediction_error(image, coefficients, p)


def me_mask_from_error(error: torch.Tensor) -> torch.Tensor:
    """Normalized |error| mask: |e| / max|e| per image."""
    abs_error = error.abs()
    return abs_error / abs_error.amax(dim=(-2, -1), keepdim=True)
