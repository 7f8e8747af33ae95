"""The ME predictor's coefficient solves (``csrc/spd_solve.cu``) and their
plain PyTorch versions.

* ``spd_solve8``: the 3x3 predictor's 8x8 systems. The (B, 9, 9) Gram of
  ``me_gram`` holds Rx = G[:, :8, :8] and rx = G[:, :8, 8]; the kernel reads
  both in place and solves Rx a = rx by the unrolled 8x8 Cholesky of the
  plain version ``ops/me.py::solve_coefficients_spd``, one thread a system,
  in the plain version's order of rounded operations.
* ``spd_solve_wide``: the 24-, 48- and 80-unknown systems of p = 5, 7, 9,
  from the (B, k+1, k+1) Gram of ``me_gram_wide`` in place, by the blocked
  Cholesky of ``ops/me.py::solve_coefficients_spd_blocked``, one thread
  block a system.

Counterparts of the JAX package's ``ops/me.py::solve_coefficients_spd`` and
``solve_coefficients_spd_blocked``, XLA code that its jitted step fuses;
eager PyTorch runs those recurrences as hundreds to thousands of launches a
solve, each kernel as one.
"""

from __future__ import annotations

import torch

from ..me import solve_coefficients_spd, solve_coefficients_spd_blocked
from . import build

WIDE_UNKNOWNS = (24, 48, 80)


def spd_solve8_plain(gram: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, 9, 9) Gram -> ((B, 8) coefficients, (B,) valid) by the unrolled
    (B,)-vector Cholesky."""
    return solve_coefficients_spd(gram[:, :8, :8], gram[:, :8, 8])


def spd_solve8(gram: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, 9, 9) f32 Gram -> ((B, 8) coefficients, (B,) bool valid): valid
    is False where a coefficient is not finite (a zero or negative pivot),
    and that system's coefficients are zeros.

    CPU tensors take ``spd_solve8_plain``; CUDA tensors launch the kernel,
    one count in ``spd_solve8.launches`` a call.
    """
    if gram.device.type == "cpu":
        return spd_solve8_plain(gram)
    if gram.device.type != "cuda" or gram.ndim != 3:
        raise ValueError(f"spd_solve8 takes a (B, 9, 9) CUDA or CPU tensor, "
                         f"got {tuple(gram.shape)} on {gram.device}")
    batch = gram.shape[0]
    build.check_input("gram", gram, (batch, 9, 9), gram.device)
    coefficients = torch.empty((batch, 8), dtype=torch.float32,
                               device=gram.device)
    valid = torch.empty(batch, dtype=torch.bool, device=gram.device)
    build.launch("wm_spd_solve8", gram.device, gram.data_ptr(),
                 coefficients.data_ptr(), valid.data_ptr(), batch)
    spd_solve8.launches += 1
    return coefficients, valid


spd_solve8.launches = 0


def spd_solve_wide_plain(gram: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, k+1, k+1) Gram -> ((B, k) coefficients, (B,) valid) by the
    blocked Cholesky of the JAX package."""
    k = gram.shape[-1] - 1
    return solve_coefficients_spd_blocked(gram[:, :k, :k], gram[:, :k, k])


def spd_solve_wide(gram: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, k+1, k+1) f32 Gram, k in {24, 48, 80} -> ((B, k) coefficients,
    (B,) bool valid): valid is False where a coefficient is not finite (a
    zero or negative pivot), and that system's coefficients are zeros.

    CPU tensors take ``spd_solve_wide_plain``; CUDA tensors launch the
    kernel, one count in ``spd_solve_wide.launches`` a call. Another
    device, shape or dtype raises ``ValueError``.
    """
    k = gram.shape[-1] - 1 if gram.ndim == 3 else -1
    if k not in WIDE_UNKNOWNS or gram.device.type not in ("cpu", "cuda"):
        raise ValueError(f"spd_solve_wide takes a (B, k+1, k+1) CUDA or CPU "
                         f"tensor, k in {WIDE_UNKNOWNS}, got "
                         f"{tuple(gram.shape)} on {gram.device}")
    batch = gram.shape[0]
    if gram.device.type == "cpu":
        if gram.dtype != torch.float32 or gram.shape[1] != k + 1:
            raise ValueError(f"spd_solve_wide takes a (B, {k + 1}, {k + 1}) "
                             f"float32 tensor, got {tuple(gram.shape)} "
                             f"{gram.dtype}")
        return spd_solve_wide_plain(gram)
    build.check_input("gram", gram, (batch, k + 1, k + 1), gram.device)
    coefficients = torch.empty((batch, k), dtype=torch.float32,
                               device=gram.device)
    valid = torch.empty(batch, dtype=torch.bool, device=gram.device)
    build.launch("wm_spd_solve_wide", gram.device, gram.data_ptr(),
                 coefficients.data_ptr(), valid.data_ptr(), batch, k)
    spd_solve_wide.launches += 1
    return coefficients, valid


spd_solve_wide.launches = 0
