"""The fused embed-field and detect-tail kernels (``csrc/fused.cu``) and
their plain PyTorch versions.

Both take p in {3, 5, 7, 9}: ME predicts with the (p*p-1)-tap window; NVF
takes its variance over p x p and, in detection, predicts with the fixed
3x3 window (reference Watermark.cpp:238-241).

* ``embed_field``: the unnormalized watermark field u_raw = mask * W, with
  mask = |e| (ME, e = x - sum_k c_k x_nbr) or the NVF mask, plus per image
  sum(u_raw^2) and max|e| (the max of the NVF mask for NVF, unused there).
  The ME mask's 1/max|e| cancels in the embedded pixels, so it is not
  applied; max|e| only feeds the reported strength.
* ``detect_partials``: per image (sum e_u*e_z, sum e_u^2, sum e_z^2) with
  e_z = x - predict(x), u = mask * W, e_u = u - predict(u). The prediction
  of u reads u's own clamp-to-edge ring (reference Watermark.cpp:221-225).

Counterparts of the JAX package's ``ops/pallas/fused.py``
``fused_embed_field`` and ``fused_detect_tail``.

Halo form (a row shard of a frame, ``parallel/spatial.py``; the JAX
package's ``*_padded`` kernels with exchanged rows spliced into their
padding): ``image`` is (B, top + H + bottom, W), H owned rows with ``top``
rows above and ``bottom`` below, true neighbour rows at a seam and
replicated edge rows at the frame's border; rows read clamp to that range,
columns to the frame, and the outputs cover the owned rows only. The
embed field's watermark is (H, W), the owned rows; the detect tail's is
extended as the image is, and it takes the shard's first row in the frame,
``row_start``, and the frame's ``total_rows``: u's ring is clamp-to-edge of
u only at the frame's top (``row_start == 0``) and bottom (``row_start + H
== total_rows``), and is u of the true rows at a seam, so a seam needs
``stencil_reach`` rows of halo. ``top = bottom = row_start = 0`` and
``total_rows = H`` is the frame itself.
"""

from __future__ import annotations

import contextlib
import functools

import torch

from ...utils.profiling import begin
from ..me import prediction_error, require_supported_p
from ..nvf import nvf_mask
from . import build

MASK_CODES = {"me": 0, "nvf": 1}  # the kernels' mask_type argument


def _mask_code(mask_type: str, p: int) -> int:
    require_supported_p(p)
    if mask_type not in MASK_CODES:
        raise ValueError(f"mask_type must be 'me' or 'nvf', got {mask_type!r}")
    return MASK_CODES[mask_type]


def predictor_p(mask_type: str, p: int) -> int:
    """The predictor's window: p for ME, the reference's 3x3 for NVF."""
    return p if mask_type == "me" else 3


def pipelined(mask_type: str, p: int) -> bool:
    """Does the detect tail take the pipelined schedule? At ME p=3 the
    kernel's persistent blocks walk each tile through the batch's frames;
    NVF and the wider windows keep a block a tile (``csrc/fused.cu``'s
    launcher chooses so from mask and p)."""
    return mask_type == "me" and p == 3


@functools.cache
def detect_blocks(device: torch.device, rows: int, cols: int, code: int,
                  p: int) -> int:
    """Blocks a frame's detect-tail partials hold on ``device``: the
    pipelined kernel's grid (as many blocks as the card holds at once,
    spread evenly over the tiles) or a block a tile."""
    with (torch.cuda.device(device) if device.type == "cuda"
          else contextlib.nullcontext()):
        blocks = build.num_blocks("wm_detect_partials", rows, cols, code, p)
    if blocks < 1:
        raise RuntimeError(f"wm_detect_partials_num_blocks: CUDA error "
                           f"{-blocks}")
    return blocks


def stencil_reach(mask_type: str, p: int) -> int:
    """Rows beyond its own that the detect tail reads at a seam: the u ring
    (the predictor's half-width ph) needs e_z and the mask ph further out,
    the NVF mask its window's half-width around the ring (``detect_halo``
    in csrc/common.cuh; the JAX package's ``fused.stencil_reach``)."""
    ph = predictor_p(mask_type, p) // 2
    return 2 * ph if mask_type == "me" else ph + max(p // 2, ph)


def _rows(image: torch.Tensor, top: int, bottom: int, lo: int,
          hi: int) -> torch.Tensor:
    """Rows [lo, hi) of a halo-form shard, counted from its first owned
    row, clamped to its rows."""
    rows = image.shape[-2] - top - bottom
    index = torch.arange(lo, hi, device=image.device).clamp(
        -top, rows + bottom - 1) + top
    return image.index_select(-2, index)


def check_halo(image: torch.Tensor, top: int, bottom: int, reach: int = 0,
               row_start: int = 0, total_rows: int | None = None,
               what: str = "", reach_top: int | None = None
               ) -> tuple[int, int]:
    """Raise on halo-form arguments the kernels do not take; returns
    (owned rows, total_rows). A seam (an edge of the shard that is not the
    frame's) must have ``reach`` rows of halo (``reach_top`` at the top
    seam, if given): a shorter one would read clamped rows where the frame
    has true ones."""
    if top < 0 or bottom < 0:
        raise ValueError(f"halo rows must be >= 0, got top={top}, "
                         f"bottom={bottom}")
    rows = image.shape[-2] - top - bottom
    if rows < 1:
        raise ValueError(f"a shard of {image.shape[-2]} rows holds no owned "
                         f"row with top={top}, bottom={bottom}")
    total_rows = row_start + rows if total_rows is None else total_rows
    if row_start < 0 or total_rows < row_start + rows:
        raise ValueError(f"rows [{row_start}, {row_start + rows}) do not lie "
                         f"in a frame of {total_rows} rows")
    above = reach if reach_top is None else reach_top
    for side, halo, seam, need in (
            ("top", top, row_start > 0, above),
            ("bottom", bottom, row_start + rows < total_rows, reach)):
        if seam and halo < need:
            raise ValueError(
                f"the {side} seam of rows [{row_start}, {row_start + rows}) "
                f"needs {need} rows of halo for {what}, got {halo}")
    return rows, total_rows


def embed_field_plain(image: torch.Tensor, watermark: torch.Tensor,
                      coefficients: torch.Tensor | None,
                      mask_type: str = "me", p: int = 3, top: int = 0,
                      bottom: int = 0
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, H, W) -> (u_raw (B, H, W), sum_u2 (B,), max_e (B,)); the halo
    form takes a (B, top + H + bottom, W) shard."""
    if _mask_code(mask_type, p) == MASK_CODES["me"]:
        mask = prediction_error(image, coefficients, p, top, bottom).abs()
    else:
        mask = nvf_mask(image, p, top, bottom)
    u_raw = mask * watermark
    return (u_raw, (u_raw * u_raw).sum(dim=(-2, -1)),
            mask.amax(dim=(-2, -1)))


def tail_analysis(image: torch.Tensor, coefficients: torch.Tensor,
                  mask_type: str, p: int, top: int = 0, bottom: int = 0
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """The image-only part of detection on a (B, top + H + bottom, W)
    shard: (e_z (B, H, W) of the owned rows, the mask (B, H + 2 ph, W) over
    them and u's ring of ph = pred_p // 2 rows each side), e_z and the mask
    of the ring read ``stencil_reach`` rows beyond the shard."""
    pred_p = predictor_p(mask_type, p)
    ph = pred_p // 2
    rows = image.shape[-2] - top - bottom
    # the shard with exactly `reach` rows around its owned ones, so the
    # region rows [-ph, H + ph) have `inner` rows of halo each side
    reach = stencil_reach(mask_type, p)
    inner = reach - ph
    frame = _rows(image, top, bottom, -reach, rows + reach)
    e_region = prediction_error(frame, coefficients, pred_p, inner, inner)
    mask = (e_region.abs() if _mask_code(mask_type, p) == MASK_CODES["me"]
            else nvf_mask(frame, p, inner, inner))
    return e_region[..., ph:ph + rows, :], mask


def tail_u(mask: torch.Tensor, watermark: torch.Tensor, ph: int, top: int,
           bottom: int, row_start: int, total_rows: int) -> torch.Tensor:
    """u = mask * W over the owned rows and its ring of ph rows (``mask``
    from ``tail_analysis``; ``watermark`` (..., top + H + bottom, W) rows
    that broadcast against it), with the ring rows outside the frame set to
    u's edge rows."""
    rows = watermark.shape[-2] - top - bottom
    u = mask * _rows(watermark, top, bottom, -ph, rows + ph)
    if row_start == 0:
        u[..., :ph, :] = u[..., ph:ph + 1, :]
    if row_start + rows == total_rows:
        u[..., ph + rows:, :] = u[..., ph + rows - 1:ph + rows, :]
    return u


def detect_partials_plain(image: torch.Tensor, watermark: torch.Tensor,
                          coefficients: torch.Tensor, mask_type: str = "me",
                          p: int = 3, top: int = 0, bottom: int = 0,
                          row_start: int = 0, total_rows: int | None = None
                          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, H, W) -> (dot (B,), ||e_u||^2 (B,), ||e_z||^2 (B,)); the halo
    form takes a (B, top + H + bottom, W) shard and its (top + H + bottom,
    W) watermark rows.

    u is formed over the owned rows and its ring of ph = pred_p // 2 rows
    from e_z and the mask there (which read ``stencil_reach`` rows beyond
    the shard), then the ring rows outside the frame become u's edge rows.
    """
    rows, total_rows = check_halo(
        image, top, bottom, stencil_reach(mask_type, p), row_start,
        total_rows, f"the detect tail at {mask_type} p={p}")
    pred_p = predictor_p(mask_type, p)
    e_z, mask = tail_analysis(image, coefficients, mask_type, p, top, bottom)
    u = tail_u(mask, watermark, pred_p // 2, top, bottom, row_start,
               total_rows)
    e_u = prediction_error(u, coefficients, pred_p, pred_p // 2,
                           pred_p // 2)
    dims = (-2, -1)
    return ((e_u * e_z).sum(dim=dims), (e_u * e_u).sum(dim=dims),
            (e_z * e_z).sum(dim=dims))


def _check_launch(image: torch.Tensor, watermark: torch.Tensor,
                  coefficients: torch.Tensor | None, need_coefficients: bool,
                  taps: int, wm_rows: int) -> tuple[int, int]:
    """Check a launch's tensors; returns (batch, cols). ``wm_rows``: the
    watermark's rows."""
    if image.device.type != "cuda" or image.ndim != 3:
        raise ValueError(f"expected a (B, H, W) CUDA or CPU tensor, got "
                         f"{tuple(image.shape)} on {image.device}")
    batch, _, cols = image.shape
    build.check_input("image", image, tuple(image.shape), image.device)
    build.check_input("watermark", watermark, (wm_rows, cols), image.device)
    if need_coefficients or coefficients is not None:
        build.check_input("coefficients", coefficients, (batch, taps),
                          image.device)
    return batch, cols


def embed_field(image: torch.Tensor, watermark: torch.Tensor,
                coefficients: torch.Tensor | None, mask_type: str = "me",
                p: int = 3, top: int = 0, bottom: int = 0
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, H, W) f32 frames, (H, W) watermark, (B, p*p-1) coefficients (ME;
    may be None for NVF) -> (u_raw (B, H, W), sum_u2 (B,), max_e (B,)). The
    halo form takes (B, top + H + bottom, W) frames (module docstring).

    CPU tensors take ``embed_field_plain``; CUDA tensors launch the kernel;
    ``embed_field.nvf`` counts the launches at the NVF mask.
    """
    span = begin("kernels.embed_field")
    try:
        rows, _ = check_halo(image, top, bottom)
        if image.device.type == "cpu":
            return embed_field_plain(image, watermark, coefficients,
                                     mask_type, p, top, bottom)
        code = _mask_code(mask_type, p)
        batch, cols = _check_launch(image, watermark, coefficients,
                                    code == MASK_CODES["me"], p * p - 1, rows)
        u_raw = torch.empty((batch, rows, cols), dtype=torch.float32,
                            device=image.device)
        blocks = build.num_blocks("wm_embed_field", rows, cols, code, p)
        partials = torch.empty((batch, blocks, 2), dtype=torch.float32,
                               device=image.device)
        build.launch("wm_embed_field", image.device, image.data_ptr(),
                     watermark.data_ptr(),
                     None if coefficients is None else coefficients.data_ptr(),
                     u_raw.data_ptr(), partials.data_ptr(), batch, rows, cols,
                     code, p, top, bottom)
        embed_field.launches += 1
        embed_field.nvf += code == MASK_CODES["nvf"]
        return u_raw, partials[..., 0].sum(dim=1), partials[..., 1].amax(dim=1)
    finally:
        if span:
            span.end()


def detect_partials(image: torch.Tensor, watermark: torch.Tensor,
                    coefficients: torch.Tensor, mask_type: str = "me",
                    p: int = 3, top: int = 0, bottom: int = 0,
                    row_start: int = 0, total_rows: int | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, H, W) f32 frames, (H, W) watermark, (B, k) coefficients (k =
    p*p-1 for ME, 8 for NVF) -> (dot (B,), ||e_u||^2 (B,), ||e_z||^2 (B,)).
    The halo form takes (B, top + H + bottom, W) frames, the watermark's
    same rows, and the shard's place in the frame (module docstring).

    CPU tensors take ``detect_partials_plain``; CUDA tensors launch the
    kernel; ``detect_partials.pipelined`` counts the launches that took
    the pipelined schedule (``pipelined``), ``detect_partials.nvf`` those
    at the NVF mask.
    """
    span = begin("kernels.detect_partials")
    try:
        rows, total_rows = check_halo(
            image, top, bottom, stencil_reach(mask_type, p), row_start,
            total_rows, f"the detect tail at {mask_type} p={p}")
        if image.device.type == "cpu":
            return detect_partials_plain(image, watermark, coefficients,
                                         mask_type, p, top, bottom, row_start,
                                         total_rows)
        code = _mask_code(mask_type, p)
        taps = predictor_p(mask_type, p) ** 2 - 1
        batch, cols = _check_launch(image, watermark, coefficients, True, taps,
                                    image.shape[1])
        partials = torch.empty(
            (batch, detect_blocks(image.device, rows, cols, code, p), 3),
            dtype=torch.float32, device=image.device)
        build.launch("wm_detect_partials", image.device, image.data_ptr(),
                     watermark.data_ptr(), coefficients.data_ptr(),
                     partials.data_ptr(), batch, rows, cols, code, p, top,
                     bottom, row_start, total_rows)
        detect_partials.launches += 1
        detect_partials.pipelined += pipelined(mask_type, p)
        detect_partials.nvf += code == MASK_CODES["nvf"]
        sums = partials.sum(dim=1)
        return sums[:, 0], sums[:, 1], sums[:, 2]
    finally:
        if span:
            span.end()


embed_field.launches = 0
embed_field.nvf = 0
detect_partials.launches = 0
detect_partials.pipelined = 0
detect_partials.nvf = 0
