"""One bulk step at the NVF mask: embed the watermark into B frames, then
detect it in the marked frames (upstream's ``loops_for_test`` mode,
batched, as ``testForImage`` runs NVF).

Counted for the operation, not for the kernels that do it today, by
``step.py``'s rules. Bytes: the frames and the watermark read once, the
marked frames written once, a strength and a correlation a frame. Flops a
pixel, with the NVF mask over a p x p window, 4(p - 1) + 1 + 6 (separable
box sums of x and x^2, one square, then the mean, E[x^2], the variance and
var / (1 + var)), and the detect's 3x3 predictor of k = 8 taps and L = 13
canonical lags:

* one Gram (the marked frame's, for the detect; the embed needs no
  predictor): a product and a sum a lag, 2L;
* the embed: the NVF mask, u = mask * W (1), u^2 summed (2), the finish's
  product, sum and clamp (4): mask + 7;
* the detect: e_z and e_u (2k each), the NVF mask, u (1), three sums (6):
  4k + mask + 7;
* one solve a frame, ``cholesky_ops(k)``.
"""

from __future__ import annotations

from .kernels import cholesky_ops
from .step import lags

PREDICTOR_P = 3


def nvf_flops(p: int) -> int:
    return 4 * (p - 1) + 1 + 6


def counts(config: dict, params: dict) -> tuple[float, float]:
    p = config["p"]
    if config["mask"] != "nvf":
        raise ValueError("the NVF step's count is for the NVF mask")
    batch, rows, cols = params["batch"], config["rows"], config["cols"]
    k = PREDICTOR_P * PREDICTOR_P - 1
    mask = nvf_flops(p)
    pixels = batch * rows * cols
    nbytes = 4 * pixels + 4 * rows * cols + 4 * pixels + 8 * batch
    flops = ((2 * lags(PREDICTOR_P) + (mask + 7) + (4 * k + mask + 7))
             * pixels + batch * cholesky_ops(k))
    return nbytes, flops
