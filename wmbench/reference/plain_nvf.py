"""The plain reference of the NVF mask: embed and detect from the equations.

Written from the upstream project's definitions (kar-dim/Watermarking-GPU,
``kernels/nvf.hpp``, ``Watermark.cpp``) and imports nothing of the program
under test. The NVF mask of a frame x is var / (1 + var), with var = E[x^2]
- E[x]^2 over the p x p window around each pixel, clamped at the frame's
edge. The embed needs no predictor: u = mask * W, strength = sf /
sqrt(mean(u^2)), sf = 255 / sqrt(10^(psnr / 10)), and the marked frame is
clamp(x + u * strength, 0, 255); no frame is left unmarked. The detector
solves the frame's 3x3 predictor (``plain.coefficients``), takes e_z = x -
sum_k c_k * neighbour_k, u = the NVF mask of the frame it is given * W, e_u
the prediction error of u with the same coefficients (u's own clamped
edge), and correlates them, dot / (||e_u|| ||e_z||); a frame whose system
has no finite solution gets correlation 0.

``dtype`` is the precision the arithmetic runs in: float64 for the
reference, bfloat16 for the control (the nearest precision below the
configuration's float32); the control solves its bfloat16 Gram in float32
and rounds the coefficients back, as ``plain`` does. Frames are worked one
at a time. Order of summation: the window's sums run over its p*p planes
in row-major order, as upstream's loop over the window does; the frame's
sums (Gram, sum u^2, the correlation's three) are torch's reductions, not
upstream's.
"""

from __future__ import annotations

import torch

from .plain import _pad, coefficients, prediction_error, strength_factor

PREDICTOR_P = 3     # NVF detection predicts from the 3x3 window at every p


def nvf_mask(frame: torch.Tensor, p: int) -> torch.Tensor:
    """var / (1 + var) over the p x p clamp-to-edge window of (H, W)."""
    rows, cols = frame.shape
    h = p // 2
    padded = _pad(frame, h)
    total = torch.zeros_like(frame)
    total_sq = torch.zeros_like(frame)
    for dr in range(p):
        for dc in range(p):
            plane = padded[dr:dr + rows, dc:dc + cols]
            total = total + plane
            total_sq = total_sq + plane * plane
    mean = total / (p * p)
    variance = total_sq / (p * p) - mean * mean
    return variance / (1.0 + variance)


def embed(frames: torch.Tensor, watermark: torch.Tensor, psnr: float,
          p: int, dtype: torch.dtype = torch.float64
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, H, W) frames -> (marked frames, (B,) strengths), in ``dtype``."""
    w = watermark.to(dtype)
    sf = strength_factor(psnr)
    marked, strengths = [], []
    for frame in frames.to(dtype):
        u = nvf_mask(frame, p) * w
        strength = sf / torch.sqrt((u * u).mean())
        marked.append(torch.clamp(frame + u * strength, 0.0, 255.0))
        strengths.append(strength)
    return torch.stack(marked), torch.stack(strengths)


def _detect_frame(frame: torch.Tensor, w: torch.Tensor,
                  p: int) -> torch.Tensor:
    c, valid = coefficients(frame, PREDICTOR_P)
    if not valid:
        return frame.new_zeros(())
    e_z = prediction_error(frame, c, PREDICTOR_P)
    e_u = prediction_error(nvf_mask(frame, p) * w, c, PREDICTOR_P)
    dot = (e_u * e_z).sum()
    return dot / (torch.sqrt((e_u * e_u).sum())
                  * torch.sqrt((e_z * e_z).sum()))


def detect(frames: torch.Tensor, watermark: torch.Tensor, p: int,
           dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """(B, H, W) frames -> (B,) correlations with the watermark."""
    w = watermark.to(dtype)
    return torch.stack([_detect_frame(frame, w, p)
                        for frame in frames.to(dtype)])
