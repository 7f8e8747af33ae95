"""One bulk step: embed the watermark into B frames, then detect it in the
marked frames (upstream's ``loops_for_test`` mode, batched), ME mask.

Counted for the operation, not for the kernels that do it today. Bytes:
the frames and the watermark read once, the marked frames written once,
a strength and a correlation a frame. Flops a pixel, with k = p*p - 1 taps
and L = ((4h + 1)^2 + 1) / 2 canonical lags (h = p // 2; 13 at p = 3):

* two Grams (the frame's, for the embed, and the marked frame's, for the
  detect): a product and a sum a lag, 2L each;
* the embed: the prediction error (2k), |e| (1), u = mask * W, u^2 summed
  and max |e| (4), the finish's product, sum and clamp (4): 2k + 9;
* the detect: e_z and e_u (2k each), |e_z| (1), u (1), three sums (6):
  4k + 8;
* two solves a frame, ``cholesky_ops(k)`` each.
"""

from __future__ import annotations

from .kernels import cholesky_ops


def lags(p: int) -> int:
    h = p // 2
    return ((4 * h + 1) ** 2 + 1) // 2


def counts(config: dict, params: dict) -> tuple[float, float]:
    p = config["p"]
    if config["mask"] != "me":
        raise ValueError("the step's count is for the ME mask")
    batch, rows, cols = params["batch"], config["rows"], config["cols"]
    k = p * p - 1
    pixels = batch * rows * cols
    nbytes = 4 * pixels + 4 * rows * cols + 4 * pixels + 8 * batch
    flops = ((4 * lags(p) + (2 * k + 9) + (4 * k + 8)) * pixels
             + 2 * batch * cholesky_ops(k))
    return nbytes, flops
