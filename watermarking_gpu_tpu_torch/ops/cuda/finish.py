"""The embed finish (``csrc/embed_finish.cu``) and its plain PyTorch version.

After the embed field (u_raw, sum u_raw^2, max |e|) of ``n`` pixels a frame:
scale = sf * sqrt(n) / sqrt(sum u_raw^2), the strength (ME: scale * max |e|;
NVF: scale), and clamp(output + u_raw * scale, 0, 255), where a frame's
solve failed the output itself and a strength of 0. Counterpart of the
JAX package's ``ops/pipelines.py::_embed_pipeline_fused`` tail, XLA code
that its jitted step fuses into one pass; eager PyTorch runs it as nine
launches (five on (B,) vectors, four over the frames), the kernel as one.
The output may be uint8 (the video's lumas): the plain version widens it,
runs the f32 tail and casts back (truncating); the kernel reads and writes
the bytes.
"""

from __future__ import annotations

import torch

from . import build

MASK_TYPES = ("me", "nvf")


def embed_finish_plain(u_raw: torch.Tensor, output: torch.Tensor,
                       sum_u2: torch.Tensor, max_e: torch.Tensor,
                       valid: torch.Tensor, numerator: float, mask_type: str
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., H, W) u_raw, (..., H, W[, C]) f32 or uint8 output, (...,)
    sum_u2, max_e and bool valid, numerator = sf * sqrt(n) -> (watermarked
    like the output, (...,) strength): the eager tail, op for op."""
    narrow = output.dtype == torch.uint8
    if narrow:
        output = output.to(torch.float32)
    scale = numerator / torch.sqrt(sum_u2)
    strength = scale * max_e if mask_type == "me" else scale
    addend = u_raw * scale[..., None, None]
    if output.ndim == u_raw.ndim + 1:
        addend = addend[..., None]
    watermarked = torch.clamp(output + addend, 0.0, 255.0)
    gate = valid.reshape(valid.shape + (1,) * (output.ndim - valid.ndim))
    watermarked = torch.where(gate, watermarked, output)
    if narrow:
        watermarked = watermarked.to(torch.uint8)
    return watermarked, torch.where(valid, strength, 0.0)


def embed_finish(u_raw: torch.Tensor, output: torch.Tensor,
                 sum_u2: torch.Tensor, max_e: torch.Tensor,
                 valid: torch.Tensor, numerator: float, mask_type: str
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, H, W) or (H, W) f32 u_raw, a contiguous output of u_raw's shape
    or with a trailing channel axis, f32 or uint8, (B,) or () f32 sum_u2 and
    max_e and bool valid -> (watermarked, a new tensor like the output;
    strength (B,) or ()), as ``embed_finish_plain``.

    CPU tensors take ``embed_finish_plain``; CUDA tensors launch the kernel,
    one count in ``embed_finish.launches`` a call. Another device, shape or
    dtype raises ``ValueError``.
    """
    if mask_type not in MASK_TYPES:
        raise ValueError(f"mask_type must be one of {MASK_TYPES}, got "
                         f"{mask_type!r}")
    if u_raw.device.type == "cpu":
        return embed_finish_plain(u_raw, output, sum_u2, max_e, valid,
                                  numerator, mask_type)
    device = u_raw.device
    if device.type != "cuda" or u_raw.ndim not in (2, 3):
        raise ValueError(f"embed_finish takes a (B, H, W) or (H, W) CUDA or "
                         f"CPU u_raw, got {tuple(u_raw.shape)} on {device}")
    lead = tuple(u_raw.shape[:-2])
    extra = output.ndim - u_raw.ndim
    if (extra not in (0, 1) or tuple(output.shape[:u_raw.ndim])
            != tuple(u_raw.shape) or output.device != device
            or output.dtype not in (torch.float32, torch.uint8)
            or not output.is_contiguous()):
        raise ValueError(f"embed_finish: the output must be a contiguous "
                         f"float32 or uint8 tensor of shape "
                         f"{tuple(u_raw.shape)}[+ (C,)] on {device}, got "
                         f"{tuple(output.shape)} {output.dtype} on "
                         f"{output.device}")
    build.check_input("u_raw", u_raw, u_raw.shape, device)
    build.check_input("sum_u2", sum_u2, lead, device)
    build.check_input("max_e", max_e, lead, device)
    if (valid.dtype != torch.bool or tuple(valid.shape) != lead
            or valid.device != device or not valid.is_contiguous()):
        raise ValueError(f"valid must be a contiguous bool tensor of shape "
                         f"{lead} on {device}, got {tuple(valid.shape)} "
                         f"{valid.dtype} on {valid.device}")
    rows, cols = u_raw.shape[-2:]
    watermarked = torch.empty_like(output)
    strength = torch.empty(lead, dtype=torch.float32, device=device)
    build.launch("wm_embed_finish", device, u_raw.data_ptr(),
                 output.data_ptr(), sum_u2.data_ptr(), max_e.data_ptr(),
                 valid.data_ptr(), watermarked.data_ptr(),
                 strength.data_ptr(), lead[0] if lead else 1, rows * cols,
                 output.shape[-1] if extra else 1, numerator,
                 int(mask_type == "me"), int(output.dtype == torch.uint8))
    embed_finish.launches += 1
    return watermarked, strength


embed_finish.launches = 0
