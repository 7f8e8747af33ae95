"""The plain reference: embed, detect and identify from the equations.

Written from the upstream project's definitions (kar-dim/Watermarking-GPU,
``Watermark.cpp``) and imports nothing of the program under test. Every
pixel is predicted from its p*p - 1 neighbours, clamped at the frame's edge,
in row-major order with the centre left out; the coefficients solve the
normal equations Rx a = rx summed over every pixel; the ME mask is
|e| / max |e| of the prediction error e; the embed adds u * strength with
u = mask * W and strength = sf / sqrt(mean(u^2)), sf = 255 / sqrt(10^(psnr /
10)), clamped to [0, 255]; the detector correlates the prediction errors of
u and of the frame, both with the frame's coefficients. A frame whose
system has no finite solution is left as it is, with strength 0 and
correlation 0.

``dtype`` is the precision the arithmetic runs in: float64 for the
reference, bfloat16 for the control (the nearest precision below the
configuration's float32). There is no bfloat16 solve, so the control
solves its bfloat16 Gram in float32 and rounds the coefficients back.
Frames are worked one at a time, and candidates in blocks, so that the
float64 planes fit beside nothing else on the card.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def strength_factor(psnr: float) -> float:
    return 255.0 / math.sqrt(10.0 ** (psnr / 10.0))


def _views(padded: torch.Tensor, p: int, rows: int, cols: int) -> list:
    """The p*p - 1 neighbour planes of (..., rows + 2h, cols + 2h), in
    row-major order, centre left out."""
    h = p // 2
    return [padded[..., h + dr:h + dr + rows, h + dc:h + dc + cols]
            for dr in range(-h, h + 1) for dc in range(-h, h + 1)
            if (dr, dc) != (0, 0)]


def _pad(x: torch.Tensor, h: int) -> torch.Tensor:
    """Clamp-to-edge padding of the last two axes of (..., H, W)."""
    lead, (rows, cols) = x.shape[:-2], x.shape[-2:]
    flat = x.reshape(-1, 1, rows, cols)
    if flat.dtype == torch.bfloat16 and flat.device.type == "cpu":
        padded = F.pad(flat.float(), (h, h, h, h), mode="replicate").to(
            flat.dtype)
    else:
        padded = F.pad(flat, (h, h, h, h), mode="replicate")
    return padded.reshape(*lead, rows + 2 * h, cols + 2 * h)


def coefficients(frame: torch.Tensor, p: int
                 ) -> tuple[torch.Tensor, bool]:
    """One (H, W) frame -> (its k predictor coefficients, solvable)."""
    rows, cols = frame.shape
    planes = _views(_pad(frame, p // 2), p, rows, cols) + [frame]
    stack = torch.stack([plane.reshape(-1) for plane in planes])
    gram = stack @ stack.T
    k = p * p - 1
    solve_dtype = (gram.dtype if gram.dtype == torch.float64
                   else torch.float32)
    system = gram.to(solve_dtype)
    solution, info = torch.linalg.solve_ex(system[:k, :k], system[:k, k])
    valid = bool(info == 0) and bool(torch.isfinite(solution).all())
    return solution.to(frame.dtype), valid


def prediction_error(x: torch.Tensor, coeffs: torch.Tensor,
                     p: int) -> torch.Tensor:
    """e = x - sum_k c_k * neighbour_k of (..., H, W) planes."""
    rows, cols = x.shape[-2:]
    error = x
    for c, view in zip(coeffs, _views(_pad(x, p // 2), p, rows, cols)):
        error = error - c * view
    return error


def _mask(error: torch.Tensor) -> torch.Tensor:
    magnitude = error.abs()
    return magnitude / magnitude.max()


def embed(frames: torch.Tensor, watermark: torch.Tensor, psnr: float,
          p: int, dtype: torch.dtype = torch.float64
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, H, W) frames -> (marked frames, (B,) strengths), in ``dtype``."""
    w = watermark.to(dtype)
    sf = strength_factor(psnr)
    marked, strengths = [], []
    for frame in frames.to(dtype):
        c, valid = coefficients(frame, p)
        if not valid:
            marked.append(frame)
            strengths.append(frame.new_zeros(()))
            continue
        u = _mask(prediction_error(frame, c, p)) * w
        strength = sf / torch.sqrt((u * u).mean())
        marked.append(torch.clamp(frame + u * strength, 0.0, 255.0))
        strengths.append(strength)
    return torch.stack(marked), torch.stack(strengths)


def _detect_frame(frame: torch.Tensor, bank: torch.Tensor, p: int,
                  block: int) -> torch.Tensor:
    """One (H, W) frame against (N, H, W) watermarks -> (N,)."""
    c, valid = coefficients(frame, p)
    if not valid:
        return frame.new_zeros(bank.shape[0])
    e_z = prediction_error(frame, c, p)
    mask = _mask(e_z)
    norm_z = torch.sqrt((e_z * e_z).sum())
    out = []
    for start in range(0, bank.shape[0], block):
        e_u = prediction_error(mask * bank[start:start + block].to(
            frame.dtype), c, p)
        dot = (e_u * e_z).sum(dim=(-2, -1))
        norm_u = torch.sqrt((e_u * e_u).sum(dim=(-2, -1)))
        out.append(dot / (norm_u * norm_z))
    return torch.cat(out)


def detect(frames: torch.Tensor, watermark: torch.Tensor, p: int,
           dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """(B, H, W) frames -> (B,) correlations with the watermark."""
    w = watermark.to(dtype)[None]
    return torch.stack([_detect_frame(frame, w, p, 1)[0]
                        for frame in frames.to(dtype)])


def detect_many(frames: torch.Tensor, bank: torch.Tensor, p: int,
                dtype: torch.dtype = torch.float64,
                block: int = 8) -> torch.Tensor:
    """(B, H, W) frames against (N, H, W) candidates -> (B, N)."""
    return torch.stack([_detect_frame(frame, bank, p, block)
                        for frame in frames.to(dtype)])
