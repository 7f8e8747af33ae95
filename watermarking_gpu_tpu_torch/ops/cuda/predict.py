"""The standalone prediction-error kernel (``csrc/predict.cu``) and its plain
PyTorch version, ``ops/me.py::prediction_error``.

e = x - sum_k c_k x_nbr(k) over the p*p-1 clamp-to-edge taps, p in
{3, 5, 7, 9}. Counterpart of the JAX package's
``ops/pallas/predict_kernel.py::prediction_error_pallas``. A standalone op:
no engine path of the port calls it. In the JAX package only the non-fused
branch of ``detect_many_pipeline`` does; the port's fused kernels run at
every geometry, so it has no such branch.
"""

from __future__ import annotations

import torch

from ..me import prediction_error as prediction_error_plain
from ..me import require_supported_p
from . import build


def prediction_error(image: torch.Tensor, coefficients: torch.Tensor,
                     p: int = 3) -> torch.Tensor:
    """(B, H, W) f32 frames, (B, p*p-1) coefficients -> (B, H, W) error.

    CPU tensors take ``prediction_error_plain``; CUDA tensors launch the
    kernel.
    """
    if image.device.type == "cpu":
        return prediction_error_plain(image, coefficients, p)
    require_supported_p(p)
    if image.device.type != "cuda" or image.ndim != 3:
        raise ValueError(f"prediction_error takes a (B, H, W) CUDA or CPU "
                         f"tensor, got {tuple(image.shape)} on "
                         f"{image.device}")
    batch, rows, cols = image.shape
    build.check_input("image", image, (batch, rows, cols), image.device)
    build.check_input("coefficients", coefficients, (batch, p * p - 1),
                      image.device)
    out = torch.empty_like(image)
    build.launch("wm_prediction_error", image.device, image.data_ptr(),
                 coefficients.data_ptr(), out.data_ptr(), batch, rows, cols,
                 p)
    prediction_error.launches += 1
    return out


prediction_error.launches = 0
