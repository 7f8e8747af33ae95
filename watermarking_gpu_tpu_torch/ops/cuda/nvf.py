"""The standalone NVF mask kernel (``csrc/nvf.cu``) and its plain PyTorch
version, ``ops/nvf.py::nvf_mask``.

var / (1 + var) over the p x p clamp-to-edge window, p in {3, 5, 7, 9}, by
separable box sums. Counterpart of the JAX package's
``ops/pallas/nvf_kernel.py::nvf_mask_pallas``. A standalone op: no pipeline
calls it, in the JAX package or here; the embed and detect paths compute
the NVF mask inside the fused kernels.
"""

from __future__ import annotations

import torch

from ...utils.profiling import begin
from ..me import require_supported_p
from ..nvf import nvf_mask as nvf_mask_plain
from . import build


def nvf_mask(image: torch.Tensor, p: int = 3) -> torch.Tensor:
    """(B, H, W) f32 frames -> (B, H, W) NVF mask; or one (H, W) frame ->
    (H, W), as ``nvf_mask_pallas`` takes it.

    CPU tensors take ``nvf_mask_plain``; CUDA tensors launch the kernel.
    """
    span = begin("kernels.nvf_mask")
    try:
        require_supported_p(p)
        if image.ndim == 2:
            return nvf_mask(image[None], p)[0]
        if image.ndim != 3:
            raise ValueError(f"nvf_mask takes a (B, H, W) or (H, W) image, "
                             f"got {tuple(image.shape)}")
        if image.device.type == "cpu":
            return nvf_mask_plain(image, p)
        if image.device.type != "cuda":
            raise ValueError(f"nvf_mask takes a CUDA or CPU tensor, got one "
                             f"on {image.device}")
        batch, rows, cols = image.shape
        build.check_input("image", image, (batch, rows, cols), image.device)
        out = torch.empty_like(image)
        build.launch("wm_nvf_mask", image.device, image.data_ptr(),
                     out.data_ptr(), batch, rows, cols, p)
        nvf_mask.launches += 1
        return out
    finally:
        if span:
            span.end()


nvf_mask.launches = 0
