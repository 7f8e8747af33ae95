"""watermarking_gpu_tpu_torch — the PyTorch/CUDA port of the JAX package.

The same spread-spectrum watermarking system (NVF and prediction-error
masks, PSNR-scaled additive embedding, correlation detection) written for
PyTorch, with the main path's stencil kernels hand-written in CUDA C++ for
Hopper (``csrc/``). The JAX package beside it is the reference this port is
tested against; this package never imports it, nor JAX.

Dispatch is by tensor device: on CPU tensors every kernel wrapper runs its
plain PyTorch version; on CUDA tensors it launches the CUDA kernel (built
with ``nvcc`` at first use) or raises.
"""

from .models import BatchedWatermark, MaskType, Watermark
from .ops import strength_factor

__version__ = "0.1.0"

__all__ = ["BatchedWatermark", "MaskType", "Watermark", "strength_factor",
           "__version__"]
