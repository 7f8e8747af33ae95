"""The 3x3 predictor's coefficient solve (``csrc/spd_solve.cu``) and its
plain PyTorch version, ``ops/me.py::solve_coefficients_spd``.

The (B, 9, 9) Gram of ``me_gram`` holds Rx = G[:, :8, :8] and
rx = G[:, :8, 8]; the kernel reads both in place and solves Rx a = rx by
the unrolled 8x8 Cholesky of the plain version, one thread a system, in the
plain version's order of rounded operations. Counterpart of the JAX
package's ``ops/me.py::solve_coefficients_spd``, XLA code that its jitted
step fuses; eager PyTorch runs that recurrence as ~470 launches a solve,
the kernel as one.
"""

from __future__ import annotations

import torch

from ..me import solve_coefficients_spd
from . import build


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
