"""The multi-candidate detect kernel (``csrc/detect_many.cu``) and its plain
PyTorch version.

Watermark identification scores B frames against a bank of N candidate
watermarks. The image-only part of detection (e_z and the mask) is shared by
every candidate; per candidate it costs u = mask * W_c, e_u = u - predict(u)
and two sums. Returns per frame and candidate (sum e_u*e_z, sum e_u^2) and
per frame sum e_z^2, with the ME mask |e_z| left unnormalized as in
``detect_partials`` (1/max|e| cancels in the correlation).

Counterpart of the JAX package's ``ops/pallas/fused.py``
``fused_detect_many_partials`` and ``fused_detect_many_partials_padded``.
The kernel reads the bank in place: no padded copy of it is made, and a
last chunk of fewer than ``chunk`` candidates is guarded in the kernel.
"""

from __future__ import annotations

import torch

from ..me import prediction_error
from ..nvf import nvf_mask
from . import build
from .fused import MASK_CODES, _mask_code, predictor_p


def detect_many_partials_plain(image: torch.Tensor, bank: torch.Tensor,
                               coefficients: torch.Tensor,
                               mask_type: str = "me", p: int = 3
                               ) -> tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """(B, H, W) frames, (N, H, W) bank, (B, k) coefficients -> (dot (B, N),
    ||e_u||^2 (B, N), ||e_z||^2 (B,)): the shared-analysis formulation of
    the JAX package's ``detect_many_pipeline``, with its (B, N, H, W) u and
    e_u planes."""
    code = _mask_code(mask_type, p)
    pred_p = predictor_p(mask_type, p)
    e_z = prediction_error(image, coefficients, pred_p)
    mask = e_z.abs() if code == MASK_CODES["me"] else nvf_mask(image, p)
    u = mask[:, None] * bank
    e_u = prediction_error(u, coefficients[:, None, :], pred_p)
    dims = (-2, -1)
    return ((e_u * e_z[:, None]).sum(dim=dims), (e_u * e_u).sum(dim=dims),
            (e_z * e_z).sum(dim=dims))


def detect_many_partials(image: torch.Tensor, bank: torch.Tensor,
                         coefficients: torch.Tensor, mask_type: str = "me",
                         p: int = 3
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, H, W) f32 frames, (N, H, W) f32 bank, (B, k) coefficients (k =
    p*p-1 for ME, 8 for NVF) -> (dot (B, N), ||e_u||^2 (B, N),
    ||e_z||^2 (B,)).

    CPU tensors take ``detect_many_partials_plain``; CUDA tensors launch the
    kernel: one block per tile of a frame and chunk of ``chunk`` candidates,
    each writing its sums to a (B, chunks, blocks, 2 * chunk + 1) partials
    buffer that is finished here.
    """
    if image.device.type == "cpu":
        return detect_many_partials_plain(image, bank, coefficients,
                                          mask_type, p)
    code = _mask_code(mask_type, p)
    if image.device.type != "cuda" or image.ndim != 3 or bank.ndim != 3:
        raise ValueError(f"expected (B, H, W) frames and an (N, H, W) bank, "
                         f"CUDA or CPU tensors, got {tuple(image.shape)} and "
                         f"{tuple(bank.shape)} on {image.device}")
    batch, rows, cols = image.shape
    n = bank.shape[0]
    taps = predictor_p(mask_type, p) ** 2 - 1
    build.check_input("image", image, (batch, rows, cols), image.device)
    build.check_input("bank", bank, (n, rows, cols), image.device)
    build.check_input("coefficients", coefficients, (batch, taps),
                      image.device)
    chunk = build.library().wm_detect_many_chunk()
    n_chunks = -(-n // chunk)
    blocks = build.num_blocks("wm_detect_many", rows, cols)
    partials = torch.empty((batch, n_chunks, blocks, 2 * chunk + 1),
                           dtype=torch.float32, device=image.device)
    build.launch("wm_detect_many", image.device, image.data_ptr(),
                 bank.data_ptr(), coefficients.data_ptr(),
                 partials.data_ptr(), batch, n, rows, cols, code, p)
    detect_many_partials.launches += 1
    sums = partials.sum(dim=2)
    dot = sums[:, :, 0:2 * chunk:2].reshape(batch, -1)[:, :n]
    norm_u = sums[:, :, 1:2 * chunk:2].reshape(batch, -1)[:, :n]
    return dot, norm_u, sums[:, 0, 2 * chunk]


detect_many_partials.launches = 0
