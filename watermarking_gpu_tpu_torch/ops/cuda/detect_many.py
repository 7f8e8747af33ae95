"""The multi-candidate detect kernel (``csrc/detect_many.cu``) and its plain
PyTorch version.

Watermark identification scores B frames against a bank of N candidate
watermarks. The image-only part of detection (e_z and the mask) is shared by
every candidate; per candidate it costs u = mask * W_c, e_u = u - predict(u)
and two sums. Returns per frame and candidate (sum e_u*e_z, sum e_u^2) and
per frame sum e_z^2, with the ME mask |e_z| left unnormalized as in
``detect_partials`` (1/max|e| cancels in the correlation).

Counterpart of the JAX package's ``ops/pallas/fused.py``
``fused_detect_many_partials`` and ``fused_detect_many_partials_padded``.
The kernel reads the bank in place: no padded copy of it is made, and a
last chunk of fewer than ``chunk`` candidates is guarded in the kernel.

Halo form (a row shard of a frame, ``parallel/spatial.py``; the JAX
package's ``_detect_many_shard_pallas``): the detect tail's contract
(``ops.cuda.fused``). The image is (B, top + H + bottom, W) and the bank
(N, top + H + bottom, W), with the same rows around the H owned ones; the
sums cover the owned rows, u's ring is clamp-to-edge of u only at the
frame's top (``row_start == 0``) and bottom (``row_start + H ==
total_rows``) and is u of the true rows at a seam, which needs
``stencil_reach`` rows of halo. ``top = bottom = row_start = 0`` and
``total_rows = H`` is the frame itself.
"""

from __future__ import annotations

import functools

import torch

from ...utils.profiling import begin
from ..me import prediction_error
from . import build
from .fused import (_mask_code, check_halo, predictor_p, stencil_reach,
                    tail_analysis, tail_u)


def detect_many_partials_plain(image: torch.Tensor, bank: torch.Tensor,
                               coefficients: torch.Tensor,
                               mask_type: str = "me", p: int = 3,
                               top: int = 0, bottom: int = 0,
                               row_start: int = 0,
                               total_rows: int | None = None
                               ) -> tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """(B, H, W) frames, (N, H, W) bank, (B, k) coefficients -> (dot (B, N),
    ||e_u||^2 (B, N), ||e_z||^2 (B,)): the shared-analysis formulation of
    the JAX package's ``detect_many_pipeline``, with its (B, N, H, W) u and
    e_u planes; the halo form takes (B, top + H + bottom, W) frames and an
    (N, top + H + bottom, W) bank, as ``detect_partials_plain`` does."""
    rows, total_rows = check_halo(
        image, top, bottom, stencil_reach(mask_type, p), row_start,
        total_rows, f"the multi-candidate kernel at {mask_type} p={p}")
    pred_p = predictor_p(mask_type, p)
    ph = pred_p // 2
    e_z, mask = tail_analysis(image, coefficients, mask_type, p, top, bottom)
    u = tail_u(mask[:, None], bank, ph, top, bottom, row_start, total_rows)
    e_u = prediction_error(u, coefficients[:, None, :], pred_p, ph, ph)
    dims = (-2, -1)
    return ((e_u * e_z[:, None]).sum(dim=dims), (e_u * e_u).sum(dim=dims),
            (e_z * e_z).sum(dim=dims))


def detect_many_partials(image: torch.Tensor, bank: torch.Tensor,
                         coefficients: torch.Tensor, mask_type: str = "me",
                         p: int = 3, top: int = 0, bottom: int = 0,
                         row_start: int = 0, total_rows: int | None = None
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, H, W) f32 frames, (N, H, W) f32 bank, (B, k) coefficients (k =
    p*p-1 for ME, 8 for NVF) -> (dot (B, N), ||e_u||^2 (B, N),
    ||e_z||^2 (B,)). The halo form takes (B, top + H + bottom, W) frames, an
    (N, top + H + bottom, W) bank and the shard's place in the frame
    (module docstring).

    CPU tensors take ``detect_many_partials_plain``; CUDA tensors launch the
    kernel: one block per tile of a frame's owned rows and chunk of
    ``chunk`` candidates, each writing its sums to a (B, chunks, blocks,
    2 * chunk + 1) partials buffer that is finished here. Where the batch
    allows it (``cluster_size``), the blocks of one tile and chunk run in
    clusters that copy each candidate's tile once for their frames;
    ``detect_many_partials.clustered`` counts those launches.
    """
    span = begin("kernels.detect_many")
    try:
        rows, total_rows = check_halo(
            image, top, bottom, stencil_reach(mask_type, p), row_start,
            total_rows, f"the multi-candidate kernel at {mask_type} p={p}")
        if image.device.type == "cpu":
            return detect_many_partials_plain(image, bank, coefficients,
                                              mask_type, p, top, bottom,
                                              row_start, total_rows)
        code = _mask_code(mask_type, p)
        if image.device.type != "cuda" or image.ndim != 3 or bank.ndim != 3:
            raise ValueError(
                f"expected (B, H, W) frames and an (N, H, W) bank, CUDA or "
                f"CPU tensors, got {tuple(image.shape)} and "
                f"{tuple(bank.shape)} on {image.device}")
        batch, img_rows, cols = image.shape
        n = bank.shape[0]
        taps = predictor_p(mask_type, p) ** 2 - 1
        build.check_input("image", image, (batch, img_rows, cols),
                          image.device)
        build.check_input("bank", bank, (n, img_rows, cols), image.device)
        build.check_input("coefficients", coefficients, (batch, taps),
                          image.device)
        chunk = build.library().wm_detect_many_chunk()
        n_chunks = -(-n // chunk)
        blocks = build.num_blocks("wm_detect_many", rows, cols)
        partials = torch.empty((batch, n_chunks, blocks, 2 * chunk + 1),
                               dtype=torch.float32, device=image.device)
        build.launch("wm_detect_many", image.device, image.data_ptr(),
                     bank.data_ptr(), coefficients.data_ptr(),
                     partials.data_ptr(), batch, n, rows, cols, code, p, top,
                     bottom, row_start, total_rows)
        detect_many_partials.launches += 1
        detect_many_partials.clustered += cluster_size(
            image.device, batch, code, p) > 1
        sums = partials.sum(dim=2)
        dot = sums[:, :, 0:2 * chunk:2].reshape(batch, -1)[:, :n]
        norm_u = sums[:, :, 1:2 * chunk:2].reshape(batch, -1)[:, :n]
        return dot, norm_u, sums[:, 0, 2 * chunk]
    finally:
        if span:
            span.end()


detect_many_partials.launches = 0
detect_many_partials.clustered = 0


@functools.cache
def cluster_size(device: torch.device, batch: int, mask_code: int,
                 p: int) -> int:
    """Frames a cluster of the kernel's launch for ``batch`` frames on
    ``device`` (the C entry's own choice): 2 at a 3 x 3 predictor (ME p=3,
    NVF) where the batch is even and the card can schedule the pair, else
    1."""
    with torch.cuda.device(device):
        return int(build.library().wm_detect_many_cluster(batch, mask_code,
                                                          p))
