"""One identification call: B frames scored against a bank of N candidate
watermarks (``BatchedWatermark.detect_many``), ME mask.

Counted for the operation. Bytes: the frames and the bank read once, the
(B, N) correlations written. Flops a pixel, with k = p*p - 1 taps and L
canonical lags (``step.lags``): the frame's Gram (2L), and the
multi-candidate detect as ``kernels.kernel_bound("detect_many")`` counts
it, per candidate u = mask * W_c, e_u and two sums (2k + 5), per frame e_z,
|e_z| and e_z^2 (2k + 3); one solve a frame.
"""

from __future__ import annotations

from .kernels import cholesky_ops
from .step import lags


def counts(config: dict, params: dict) -> tuple[float, float]:
    p = config["p"]
    if config["mask"] != "me":
        raise ValueError("the identification count is for the ME mask")
    batch, n = params["batch"], params["candidates"]
    rows, cols = config["rows"], config["cols"]
    k = p * p - 1
    pixels = batch * rows * cols
    nbytes = 4 * pixels + 4 * n * rows * cols + 4 * batch * n
    flops = ((2 * lags(p) + (2 * k + 5) * n + 2 * k + 3) * pixels
             + batch * cholesky_ops(k))
    return nbytes, flops
