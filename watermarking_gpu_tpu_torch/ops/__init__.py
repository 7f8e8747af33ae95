"""Compute ops for spread-spectrum watermarking, in PyTorch.

The plain tensor versions double as the port's correctness oracle; the
hand-written CUDA kernels live under ``watermarking_gpu_tpu_torch.ops.cuda``.
"""

from .color import rgb_to_gray
from .correlation import correlation
from .embed import embed_watermark, strength_factor
from .me import (me_mask_from_error, me_normal_equations, predict,
                 prediction_error, solve_coefficients, solve_coefficients_spd,
                 solve_coefficients_spd_wide)
from .neighbors import NEIGHBOR_OFFSETS, NUM_NEIGHBORS, pad_edge
from .nvf import nvf_mask
from .pipelines import detect_many_pipeline, detect_pipeline, embed_pipeline

__all__ = [
    "NEIGHBOR_OFFSETS", "NUM_NEIGHBORS", "correlation",
    "detect_many_pipeline", "detect_pipeline", "embed_pipeline", "embed_watermark", "me_mask_from_error",
    "me_normal_equations", "nvf_mask", "pad_edge",
    "predict", "prediction_error", "rgb_to_gray", "solve_coefficients",
    "solve_coefficients_spd", "solve_coefficients_spd_wide",
    "strength_factor",
]
