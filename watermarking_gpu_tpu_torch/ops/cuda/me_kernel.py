"""The ME Gram kernel (``csrc/me_gram.cu``) and its plain PyTorch version.

One pass over a (B, H, W) stack gives the (B, 9, 9) Gram matrix of
[8 clamped neighbors; center]: ``G[:, :8, :8]`` is Rx and ``G[:, :8, 8]`` is
rx. Counterpart of the JAX package's ``ops/pallas/me_kernel.py``.
"""

from __future__ import annotations

import torch

from ..me import gram_direct
from . import build

GRAM_SLOTS = 45  # upper triangle of the 9x9, row-major (torch.triu_indices)


def me_gram_plain(image: torch.Tensor) -> torch.Tensor:
    """(B, H, W) -> (B, 9, 9) Gram from the elementwise oracle."""
    return gram_direct(image, 3)


def assemble_gram(upper: torch.Tensor) -> torch.Tensor:
    """(B, 45) upper-triangle sums -> symmetric (B, 9, 9)."""
    index = torch.triu_indices(9, 9, device=upper.device)
    gram = upper.new_empty(upper.shape[0], 9, 9)
    gram[:, index[0], index[1]] = upper
    gram[:, index[1], index[0]] = upper
    return gram


def me_gram(image: torch.Tensor) -> torch.Tensor:
    """(B, H, W) f32 -> (B, 9, 9) Gram.

    CPU tensors take ``me_gram_plain``; CUDA tensors launch the kernel (each
    block writes 45 partial sums, finished here with ``torch.sum``).
    """
    if image.device.type == "cpu":
        return me_gram_plain(image)
    if image.device.type != "cuda" or image.ndim != 3:
        raise ValueError(f"me_gram takes a (B, H, W) CUDA or CPU tensor, got "
                         f"{tuple(image.shape)} on {image.device}")
    batch, rows, cols = image.shape
    build.check_input("image", image, (batch, rows, cols), image.device)
    partials = torch.empty(
        (batch, build.num_blocks("wm_me_gram", rows, cols), GRAM_SLOTS),
        dtype=torch.float32, device=image.device)
    build.launch("wm_me_gram", image.device, image.data_ptr(),
                 partials.data_ptr(), batch, rows, cols)
    me_gram.launches += 1
    return assemble_gram(partials.sum(dim=1))


me_gram.launches = 0
