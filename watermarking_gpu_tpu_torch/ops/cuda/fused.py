"""The fused embed-field and detect-tail kernels (``csrc/fused.cu``) and
their plain PyTorch versions.

Both take p in {3, 5, 7, 9}: ME predicts with the (p*p-1)-tap window; NVF
takes its variance over p x p and, in detection, predicts with the fixed
3x3 window (reference Watermark.cpp:238-241).

* ``embed_field``: the unnormalized watermark field u_raw = mask * W, with
  mask = |e| (ME, e = x - sum_k c_k x_nbr) or the NVF mask, plus per image
  sum(u_raw^2) and max|e| (the max of the NVF mask for NVF, unused there).
  The ME mask's 1/max|e| cancels in the embedded pixels, so it is not
  applied; max|e| only feeds the reported strength.
* ``detect_partials``: per image (sum e_u*e_z, sum e_u^2, sum e_z^2) with
  e_z = x - predict(x), u = mask * W, e_u = u - predict(u). The prediction
  of u reads u's own clamp-to-edge ring (reference Watermark.cpp:221-225).

Counterparts of the JAX package's ``ops/pallas/fused.py``
``fused_embed_field`` and ``fused_detect_tail``.
"""

from __future__ import annotations

import torch

from ..me import prediction_error, require_supported_p
from ..nvf import nvf_mask
from . import build

MASK_CODES = {"me": 0, "nvf": 1}  # the kernels' mask_type argument


def _mask_code(mask_type: str, p: int) -> int:
    require_supported_p(p)
    if mask_type not in MASK_CODES:
        raise ValueError(f"mask_type must be 'me' or 'nvf', got {mask_type!r}")
    return MASK_CODES[mask_type]


def predictor_p(mask_type: str, p: int) -> int:
    """The predictor's window: p for ME, the reference's 3x3 for NVF."""
    return p if mask_type == "me" else 3


def embed_field_plain(image: torch.Tensor, watermark: torch.Tensor,
                      coefficients: torch.Tensor | None,
                      mask_type: str = "me", p: int = 3
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, H, W) -> (u_raw (B, H, W), sum_u2 (B,), max_e (B,))."""
    if _mask_code(mask_type, p) == MASK_CODES["me"]:
        mask = prediction_error(image, coefficients, p).abs()
    else:
        mask = nvf_mask(image, p)
    u_raw = mask * watermark
    return (u_raw, (u_raw * u_raw).sum(dim=(-2, -1)),
            mask.amax(dim=(-2, -1)))


def detect_partials_plain(image: torch.Tensor, watermark: torch.Tensor,
                          coefficients: torch.Tensor, mask_type: str = "me",
                          p: int = 3
                          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, H, W) -> (dot (B,), ||e_u||^2 (B,), ||e_z||^2 (B,))."""
    code = _mask_code(mask_type, p)
    pred_p = predictor_p(mask_type, p)
    e_z = prediction_error(image, coefficients, pred_p)
    mask = e_z.abs() if code == MASK_CODES["me"] else nvf_mask(image, p)
    e_u = prediction_error(mask * watermark, coefficients, pred_p)
    dims = (-2, -1)
    return ((e_u * e_z).sum(dim=dims), (e_u * e_u).sum(dim=dims),
            (e_z * e_z).sum(dim=dims))


def _check_launch(image: torch.Tensor, watermark: torch.Tensor,
                  coefficients: torch.Tensor | None, need_coefficients: bool,
                  taps: int) -> tuple[int, int, int]:
    if image.device.type != "cuda" or image.ndim != 3:
        raise ValueError(f"expected a (B, H, W) CUDA or CPU tensor, got "
                         f"{tuple(image.shape)} on {image.device}")
    batch, rows, cols = image.shape
    build.check_input("image", image, (batch, rows, cols), image.device)
    build.check_input("watermark", watermark, (rows, cols), image.device)
    if need_coefficients or coefficients is not None:
        build.check_input("coefficients", coefficients, (batch, taps),
                          image.device)
    return batch, rows, cols


def embed_field(image: torch.Tensor, watermark: torch.Tensor,
                coefficients: torch.Tensor | None, mask_type: str = "me",
                p: int = 3
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, H, W) f32 frames, (H, W) watermark, (B, p*p-1) coefficients (ME;
    may be None for NVF) -> (u_raw (B, H, W), sum_u2 (B,), max_e (B,)).

    CPU tensors take ``embed_field_plain``; CUDA tensors launch the kernel.
    """
    if image.device.type == "cpu":
        return embed_field_plain(image, watermark, coefficients, mask_type, p)
    code = _mask_code(mask_type, p)
    batch, rows, cols = _check_launch(image, watermark, coefficients,
                                      code == MASK_CODES["me"], p * p - 1)
    u_raw = torch.empty_like(image)
    partials = torch.empty(
        (batch, build.num_blocks("wm_embed_field", rows, cols, code, p), 2),
        dtype=torch.float32, device=image.device)
    build.launch("wm_embed_field", image.device, image.data_ptr(),
                 watermark.data_ptr(),
                 None if coefficients is None else coefficients.data_ptr(),
                 u_raw.data_ptr(), partials.data_ptr(), batch, rows, cols,
                 code, p)
    embed_field.launches += 1
    return u_raw, partials[..., 0].sum(dim=1), partials[..., 1].amax(dim=1)


def detect_partials(image: torch.Tensor, watermark: torch.Tensor,
                    coefficients: torch.Tensor, mask_type: str = "me",
                    p: int = 3
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, H, W) f32 frames, (H, W) watermark, (B, k) coefficients (k =
    p*p-1 for ME, 8 for NVF) -> (dot (B,), ||e_u||^2 (B,), ||e_z||^2 (B,)).

    CPU tensors take ``detect_partials_plain``; CUDA tensors launch the
    kernel.
    """
    if image.device.type == "cpu":
        return detect_partials_plain(image, watermark, coefficients,
                                     mask_type, p)
    code = _mask_code(mask_type, p)
    taps = predictor_p(mask_type, p) ** 2 - 1
    batch, rows, cols = _check_launch(image, watermark, coefficients, True,
                                      taps)
    partials = torch.empty(
        (batch, build.num_blocks("wm_detect_partials", rows, cols), 3),
        dtype=torch.float32, device=image.device)
    build.launch("wm_detect_partials", image.device, image.data_ptr(),
                 watermark.data_ptr(), coefficients.data_ptr(),
                 partials.data_ptr(), batch, rows, cols, code, p)
    detect_partials.launches += 1
    sums = partials.sum(dim=1)
    return sums[:, 0], sums[:, 1], sums[:, 2]


embed_field.launches = 0
detect_partials.launches = 0
