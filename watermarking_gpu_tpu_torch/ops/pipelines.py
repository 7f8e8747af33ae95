"""End-to-end embed/detect pipelines (reference ``Watermark.cpp:156-250``).

* ``embed_pipeline``  == ``Watermark::makeWatermark``
* ``detect_pipeline`` == ``Watermark::detectWatermark``
* ``detect_many_pipeline``: identification against N candidate watermarks,
  which the reference can only do as N ``detectWatermark`` calls

Images are (H, W) or (B, H, W); outputs may carry a trailing channel axis.
Solves, strengths and correlations are per image. The solve-failure soft
path is a per-image ``valid`` flag applied with ``torch.where``, so nothing
on the path waits for the device.

Implementations:

* ``impl="torch"``: the plain formulation — Gram by elementwise sums, LU
  solve, normalized mask, reference embed/correlation formulas. The port's
  oracle, counterpart of the JAX package's ``impl="xla"``.
* ``impl="cuda"``: the fused algebra of the JAX package's ``impl="pallas"``
  — Gram kernel and solve (at a 3x3 predictor the 8x8 Cholesky in the
  Gram's assembly kernel, above it the blocked Cholesky kernel), then one
  embed-field, detect-tail or multi-candidate detect kernel; the embed ends
  in the embed-finish kernel (the strength and the AXPY/clamp/gate). On
  CUDA frames an embed and a detect are each one call into the kernel
  library (``ops/cuda/chain.py``), the frames' sums and correlations
  finished inside the kernels; identification and frames too small for the
  wide Gram's lag form call the kernels' wrappers one by one, the detect
  with its final divisions in torch. On CPU tensors the kernels' plain
  versions run.
"""

from __future__ import annotations

import math
from typing import Literal

import torch

from ..utils.profiling import begin
from .correlation import correlation
from .cuda import (detect_chain, detect_many_partials, detect_partials,
                   embed_chain, embed_field, embed_finish, me_gram_solve8,
                   me_gram_wide, spd_solve_wide)
from .cuda.chain import applies as chain_applies
from .cuda.fused import predictor_p
from .embed import embed_watermark
from .me import (me_mask_from_error, me_normal_equations, prediction_error,
                 require_supported_p, solve_coefficients,
                 solve_coefficients_spd_wide)
from .nvf import nvf_mask

MaskTypeName = Literal["nvf", "me"]
ImplName = Literal["torch", "cuda"]
IMPLS = ("torch", "cuda")


def _check_args(mask_type: str, p: int, impl: str) -> None:
    require_supported_p(p)
    if mask_type not in ("me", "nvf"):
        raise ValueError(f"mask_type must be 'me' or 'nvf', got {mask_type!r}")
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")


def _to_f32(x: torch.Tensor) -> torch.Tensor:
    """Widen integer inputs (u8 lumas) on their device."""
    return x if x.dtype == torch.float32 else x.to(torch.float32)


def _gate(value: torch.Tensor, valid: torch.Tensor,
          fallback: torch.Tensor) -> torch.Tensor:
    """where(valid, value, fallback), valid (...,) vs value (..., H, W...)."""
    extra = value.ndim - valid.ndim
    return torch.where(valid.reshape(valid.shape + (1,) * extra), value,
                       fallback)


def _analysis(image: torch.Tensor, p: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain Gram + solve -> (coefficients (..., p*p-1), valid (...,)):
    the LU at p=3, Cholesky for the wider windows (the JAX package's
    ``_analysis`` with impl="xla")."""
    solve = solve_coefficients if p == 3 else solve_coefficients_spd_wide
    return solve(*me_normal_equations(image, p))


def _fused_analysis(img3: torch.Tensor, pred_p: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Gram kernels + Cholesky -> (coefficients (B, k), valid (B,)),
    k = pred_p**2 - 1: at pred_p=3 the 3x3 Gram whose assembly kernel also
    solves the 8x8 system (one wrapper call, two launches), above it the
    wide lag Gram and the blocked solve kernel."""
    if pred_p == 3:
        return me_gram_solve8(img3)[1:]
    return spd_solve_wide(me_gram_wide(img3, pred_p))


def _embed_fused(image, output, watermark, strength_factor_value, mask_type,
                 p):
    numerator = strength_factor_value * math.sqrt(image.shape[-2]
                                                  * image.shape[-1])
    if chain_applies(image, mask_type, p, detect=False):
        return embed_chain(image.contiguous(), output.contiguous(),
                           watermark.contiguous(), numerator, mask_type, p)
    squeeze = image.ndim == 2
    img3 = (image[None] if squeeze else image).contiguous()
    if mask_type == "me":
        coefficients, valid = _fused_analysis(img3, p)
    else:
        coefficients = None
        valid = torch.ones(img3.shape[0], dtype=torch.bool,
                           device=img3.device)
    u_raw, sum_u2, max_e = embed_field(img3, watermark.contiguous(),
                                       coefficients, mask_type, p)
    if squeeze:
        u_raw, sum_u2, max_e, valid = u_raw[0], sum_u2[0], max_e[0], valid[0]
    return embed_finish(u_raw, output.contiguous(), sum_u2, max_e, valid,
                        numerator, mask_type)


def _embed_u8_fused(lumas: torch.Tensor, watermark: torch.Tensor,
                    strength_factor_value: float, mask_type: MaskTypeName,
                    p: int = 3) -> tuple[torch.Tensor, torch.Tensor]:
    """``embed_pipeline(lumas, lumas, ..., impl="cuda")`` of uint8 lumas,
    cast back to uint8 (truncating): the lumas widen once, as the image,
    and the embed finish reads them as the output and writes the uint8
    frames itself."""
    span = begin("pipeline.embed_u8")
    try:
        _check_args(mask_type, p, "cuda")
        return _embed_fused(_to_f32(lumas), lumas, _to_f32(watermark),
                            strength_factor_value, mask_type, p)
    finally:
        if span:
            span.end()


def embed_pipeline(image: torch.Tensor, output: torch.Tensor,
                   watermark: torch.Tensor, strength_factor_value: float,
                   mask_type: MaskTypeName, p: int = 3,
                   impl: ImplName = "cuda"
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Embed into ``output`` the watermark computed from grayscale ``image``.

    Returns (watermarked, strengths). On an unsolvable ME system the output
    is returned unmodified and the strength is 0 (Watermark.cpp:164-165).
    """
    span = begin("pipeline.embed")
    try:
        _check_args(mask_type, p, impl)
        image, output, watermark = map(_to_f32, (image, output, watermark))
        if impl == "cuda":
            return _embed_fused(image, output, watermark,
                                strength_factor_value, mask_type, p)
        if mask_type == "me":
            coefficients, valid = _analysis(image, p)
            mask = me_mask_from_error(prediction_error(image, coefficients,
                                                       p))
        else:
            mask = nvf_mask(image, p)
            valid = torch.ones(image.shape[:-2], dtype=torch.bool,
                               device=image.device)
        watermarked, strength = embed_watermark(output, mask, watermark,
                                                strength_factor_value)
        return (_gate(watermarked, valid, output),
                torch.where(valid, strength, 0.0))
    finally:
        if span:
            span.end()


def detect_pipeline(image: torch.Tensor, watermark: torch.Tensor,
                    mask_type: MaskTypeName, p: int = 3,
                    impl: ImplName = "cuda") -> torch.Tensor:
    """Detector correlations for (possibly watermarked) grayscale images.

    NVF detection still runs the prediction-error analysis for the
    coefficients and error sequence, with the NVF mask in place of the ME
    mask (Watermark.cpp:238-241). Returns 0 where the system is unsolvable.
    """
    span = begin("pipeline.detect")
    try:
        _check_args(mask_type, p, impl)
        image, watermark = map(_to_f32, (image, watermark))
        if impl == "cuda" and chain_applies(image, mask_type, p,
                                            detect=True):
            return detect_chain(image.contiguous(), watermark.contiguous(),
                                mask_type, p)
        if impl == "cuda":
            squeeze = image.ndim == 2
            img3 = (image[None] if squeeze else image).contiguous()
            coefficients, valid = _fused_analysis(img3,
                                                  predictor_p(mask_type, p))
            dot, norm_u, norm_z = detect_partials(
                img3, watermark.contiguous(), coefficients, mask_type, p)
            corr = dot / torch.sqrt(norm_u * norm_z)
            if squeeze:
                corr, valid = corr[0], valid[0]
            return torch.where(valid, corr, 0.0)
        pred_p = predictor_p(mask_type, p)
        coefficients, valid = _analysis(image, pred_p)
        e_z = prediction_error(image, coefficients, pred_p)
        mask = (me_mask_from_error(e_z) if mask_type == "me"
                else nvf_mask(image, p))
        e_u = prediction_error(mask * watermark, coefficients, pred_p)
        return torch.where(valid, correlation(e_u, e_z), 0.0)
    finally:
        if span:
            span.end()


def detect_many_pipeline(image: torch.Tensor, watermarks: torch.Tensor,
                         mask_type: MaskTypeName, p: int = 3,
                         impl: ImplName = "cuda") -> torch.Tensor:
    """Watermark identification: which of N candidate matrices does an image
    carry? (..., H, W) images + (N, H, W) watermarks -> (..., N)
    correlations: (H, W) gives (N,), (B, H, W) gives (B, N).

    The image-only analysis (Gram, solve, e_z, mask) runs once per image and
    is shared by all N candidates; the reference can only loop N full
    detections (``Watermark.cpp:234-250``). ``impl="cuda"`` runs the Gram
    kernel and then the multi-candidate kernel, which never materializes the
    (B, N, H, W) u and e_u of ``impl="torch"``'s formulation, at every
    geometry, bank size and window: unlike the JAX package's kernel, whose
    strips of candidate planes must fit a TPU core's VMEM, a block stages one
    fixed tile of one frame and scores the bank in chunks of a fixed size
    read in place, so its shared memory grows with neither the frame nor the
    bank. Returns 0 for every candidate of an unsolvable image.
    """
    span = begin("pipeline.detect_many")
    try:
        _check_args(mask_type, p, impl)
        image, watermarks = map(_to_f32, (image, watermarks))
        n, rows, cols = watermarks.shape
        batch_shape = image.shape[:-2]
        pred_p = predictor_p(mask_type, p)
        if impl == "cuda":
            img3 = image.reshape(-1, rows, cols).contiguous()
            coefficients, valid = _fused_analysis(img3, pred_p)
            dot, norm_u, norm_z = detect_many_partials(
                img3, watermarks.contiguous(), coefficients, mask_type, p)
            corr = dot / torch.sqrt(norm_u * norm_z[:, None])
            corr = torch.where(valid[:, None], corr, 0.0)
            return corr.reshape(batch_shape + (n,))
        coefficients, valid = _analysis(image, pred_p)
        e_z = prediction_error(image, coefficients, pred_p)
        mask = (me_mask_from_error(e_z) if mask_type == "me"
                else nvf_mask(image, p))
        u = mask[..., None, :, :] * watermarks               # (..., N, H, W)
        e_u = prediction_error(u, coefficients[..., None, :], pred_p)
        dims = (-2, -1)
        dot = (e_u * e_z[..., None, :, :]).sum(dim=dims)
        norm_u = torch.sqrt((e_u * e_u).sum(dim=dims))
        norm_z = torch.sqrt((e_z * e_z).sum(dim=dims))
        return torch.where(valid[..., None],
                           dot / (norm_u * norm_z[..., None]), 0.0)
    finally:
        if span:
            span.end()
