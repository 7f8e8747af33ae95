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

from ...utils.profiling import begin
from ..me import prediction_error as prediction_error_plain
from ..me import require_supported_p
from . import build


def prediction_error(image: torch.Tensor, coefficients: torch.Tensor,
                     p: int = 3) -> torch.Tensor:
    """(B, H, W) f32 frames, (B, p*p-1) coefficients -> (B, H, W) error;
    or one (H, W) frame with (p*p-1,) coefficients -> (H, W), as
    ``prediction_error_pallas`` takes them.

    CPU tensors take ``prediction_error_plain``; CUDA tensors launch the
    kernel.
    """
    span = begin("kernels.prediction_error")
    try:
        require_supported_p(p)
        if image.ndim == 2:
            if tuple(coefficients.shape) != (p * p - 1,):
                raise ValueError(f"coefficients must have shape "
                                 f"({p * p - 1},) for an (H, W) image, got "
                                 f"{tuple(coefficients.shape)}")
            return prediction_error(image[None], coefficients[None], p)[0]
        if image.ndim != 3:
            raise ValueError(f"prediction_error takes a (B, H, W) or (H, W) "
                             f"image, got {tuple(image.shape)}")
        batch, rows, cols = image.shape
        if tuple(coefficients.shape) != (batch, p * p - 1):
            raise ValueError(f"coefficients must have shape "
                             f"{(batch, p * p - 1)}, got "
                             f"{tuple(coefficients.shape)}")
        if image.device.type == "cpu":
            return prediction_error_plain(image, coefficients, p)
        if image.device.type != "cuda":
            raise ValueError(f"prediction_error takes a CUDA or CPU tensor, "
                             f"got one on {image.device}")
        build.check_input("image", image, (batch, rows, cols), image.device)
        build.check_input("coefficients", coefficients, (batch, p * p - 1),
                          image.device)
        out = torch.empty_like(image)
        build.launch("wm_prediction_error", image.device, image.data_ptr(),
                     coefficients.data_ptr(), out.data_ptr(), batch, rows,
                     cols, p)
        prediction_error.launches += 1
        return out
    finally:
        if span:
            span.end()


prediction_error.launches = 0
