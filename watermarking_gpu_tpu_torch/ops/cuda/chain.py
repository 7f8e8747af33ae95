"""The fused embed and the fused detect of whole frames on the card, each
enqueued by one call into the kernel library (``csrc/chain.cu``).

* ``embed_chain``: the predictor's analysis (ME: at a 3x3 predictor the lag
  kernel and the solving assembly, above it the wide lag kernel, the wide
  assembly and the blocked solve; NVF has none and every frame is valid),
  the embed field, whose last block of a frame finishes the frame's sum
  u_raw^2 and max mask, and the embed finish. Returns (marked, strength)
  as ``embed_finish`` does.
* ``detect_chain``: the predictor's analysis (NVF's is the 3x3 one), then
  the detect tail, whose last block of a frame (at ME p=3, of a chunk of
  frames) writes the frame's correlation dot / sqrt(||e_u||^2 ||e_z||^2),
  0 where its solve failed.

The kernels are those of the per-kernel wrappers, launched through the
same C entries, and each launch counts in its own wrapper's ``launches``
(``me_gram_solve8`` one a 3x3 analysis, as the per-wrapper route counts
it; ``detect_partials.pipelined``, ``embed_field.nvf`` and
``detect_partials.nvf`` as those wrappers count them); the call counts
once in ``embed_chain.launches`` or ``detect_chain.launches``. Per call:
the inputs are checked once, one allocation holds every intermediate
(lag sums, the wide Gram's edges, the Gram, coefficients, valid, the
frames' done counters, u_raw, the partials and the frames' totals), one
each the outputs; the wide analysis also
gathers the frames' boundary banks (``ops.me.frame_banks``) before the
call. No torch op runs between the kernels. Only the frames' sums differ
from the per-wrapper route's, in order: the blocks' partials are added in
their index order, where that route's torch ``sum`` takes its own.

The route is chosen from what a call shows (``applies``): CUDA frames,
(B, H, W) or (H, W), and at ME p > 3 a frame with the wide lag form
(rows, cols >= 6h). CPU tensors, smaller frames, the halo forms
(``parallel/spatial.py``, which folds its shards' partials), identification
and the tools keep the per-kernel wrappers.
"""

from __future__ import annotations

import functools

import torch

from ...utils.profiling import begin
from ..me import (GRAM_BLOCK_COLS, LANE_BLOCK, gram_lag_layout, lag_plan,
                  wide_lag_geometry, wide_lag_layout)
from ..me import _bank_rows
from . import build
from .finish import embed_finish
from .fused import MASK_CODES, _mask_code, detect_partials, embed_field
from .fused import detect_blocks, pipelined, predictor_p
from .me_gram_wide import _tables, wide_assemble, wide_lag_strips
from .me_kernel import me_gram_assemble, me_gram_lags, me_gram_solve8
from .solve import spd_solve_wide

_ALIGN = 16   # every buffer of the scratch starts on a 16-byte boundary


def applies(image: torch.Tensor, mask_type: str, p: int,
            detect: bool) -> bool:
    """Does a fused embed (``detect`` False) or detect of ``image`` take
    the chain? CUDA frames, (B, H, W) or (H, W); the wide analysis needs
    the lag form's frame."""
    if not image.is_cuda or image.ndim not in (2, 3):
        return False
    pred_p = predictor_p(mask_type, p)
    if pred_p == 3 or (mask_type == "nvf" and not detect):
        return True
    return wide_lag_geometry(image.shape[-2], image.shape[-1], pred_p)


class _Plan:
    """A geometry's scratch layout (byte offsets), the lag kernel's layout,
    and the analysis' tables, which it keeps alive."""

    def __init__(self, batch: int, rows: int, cols: int, mask_type: str,
                 p: int, detect: bool, device: torch.device):
        self.batch, self.rows, self.cols = batch, rows, cols
        self.analysis = mask_type == "me" or detect
        self.pred_p = predictor_p(mask_type, p) if self.analysis else 0
        self.wide = self.pred_p > 3
        sizes = {}
        if detect:
            self.field_blocks = detect_blocks(device, rows, cols,
                                              MASK_CODES[mask_type], p)
            sizes["partials"] = 4 * batch * self.field_blocks * 3
        else:
            self.field_blocks = build.num_blocks(
                "wm_embed_field", rows, cols, MASK_CODES[mask_type], p)
            sizes["u_raw"] = 4 * batch * rows * cols
            sizes["partials"] = 4 * batch * self.field_blocks * 2
            sizes["totals"] = 4 * 2 * batch
        self.strip = self.block = self.n_strips = self.n_blocks = 0
        self.n_lags = 0
        self.tables = None
        self.table_pointers = [None] * 4
        self.bank_rows = None
        if self.analysis:
            k = self.pred_p ** 2 - 1
            self.tables = _tables(self.pred_p, device)
            self.table_pointers = [self.tables[name].data_ptr() for name in
                                   ("lag_index", "lags", "pair_start",
                                    "pairs")]
            self.n_lags = len(lag_plan(self.pred_p)[0])
            if self.wide:
                self.strip, self.n_strips, self.n_blocks = wide_lag_layout(
                    rows, cols, self.pred_p)
                self.block = LANE_BLOCK
                self.bank_rows = _bank_rows(rows, self.pred_p // 2, device)
                sizes["edges"] = (4 * batch * self.n_lags * self.n_strips
                                  * 4 * (self.pred_p // 2))
            else:
                self.strip, self.n_strips, self.n_blocks = gram_lag_layout(
                    rows, cols)
                self.block = GRAM_BLOCK_COLS
            sizes["sums"] = (4 * batch * self.n_lags * self.n_strips
                             * self.n_blocks)
            sizes["gram"] = 4 * batch * (k + 1) ** 2
            sizes["coefficients"] = 4 * batch * k
        sizes["done"] = 4 * batch
        sizes["valid"] = batch
        self.offsets, at = {}, 0
        for name, size in sizes.items():
            self.offsets[name] = at
            at += -(-size // _ALIGN) * _ALIGN
        self.nbytes = at

    def pointers(self, base: int, names: tuple) -> list:
        """Each named buffer's address in the scratch at ``base`` (None for
        one this geometry does not use)."""
        return [base + self.offsets[name] if name in self.offsets else None
                for name in names]

    def analysis_args(self, base: int, banks: torch.Tensor | None) -> list:
        """wm_*_chain's analysis arguments, from lag_index to done."""
        return [*self.table_pointers,
                None if banks is None else banks.data_ptr(), self.strip,
                self.block, self.n_strips, self.n_blocks, self.n_lags,
                *self.pointers(base, ("sums", "edges", "gram",
                                      "coefficients", "valid", "done"))]


@functools.lru_cache(maxsize=32)
def _plan(batch: int, rows: int, cols: int, mask_type: str, p: int,
          detect: bool, device: torch.device) -> _Plan:
    return _Plan(batch, rows, cols, mask_type, p, detect, device)


def _check_frames(image: torch.Tensor, watermark: torch.Tensor) -> int:
    """Raise unless ``image`` is contiguous (B, H, W) or (H, W) CUDA f32
    frames and ``watermark`` a contiguous (H, W) f32 tensor on its device;
    returns the device's index."""
    if (not image.is_cuda or image.ndim not in (2, 3)
            or image.dtype != torch.float32 or not image.is_contiguous()):
        raise ValueError(f"the chain takes contiguous (B, H, W) or (H, W) "
                         f"float32 CUDA frames, got {tuple(image.shape)} "
                         f"{image.dtype} on {image.device}")
    index = image.get_device()
    if (watermark.get_device() != index or watermark.dtype != torch.float32
            or watermark.shape != image.shape[-2:]
            or not watermark.is_contiguous()):
        raise ValueError(f"the watermark must be a contiguous float32 "
                         f"tensor of shape {tuple(image.shape[-2:])} on "
                         f"{image.device}, got {tuple(watermark.shape)} "
                         f"{watermark.dtype} on {watermark.device}")
    return index


def _prepare(image: torch.Tensor, watermark: torch.Tensor, mask_type: str,
             p: int, output: torch.Tensor | None = None) -> tuple:
    """Check a call's frames, watermark and (an embed's) output, and
    allocate its scratch: (device index, mask code, plan, scratch, the wide
    analysis' banks or None); the caller keeps the tensors alive over the
    call."""
    code = _mask_code(mask_type, p)
    index = _check_frames(image, watermark)
    detect = output is None
    if not detect and (output.ndim - image.ndim not in (0, 1)
                       or output.shape[:image.ndim] != image.shape
                       or output.get_device() != index
                       or output.dtype not in (torch.float32, torch.uint8)
                       or not output.is_contiguous()):
        raise ValueError(f"the output must be a contiguous float32 or uint8 "
                         f"tensor of shape {tuple(image.shape)}[+ (C,)] on "
                         f"{image.device}, got {tuple(output.shape)} "
                         f"{output.dtype} on {output.device}")
    if not applies(image, mask_type, p, detect):
        raise ValueError(f"the wide analysis at p={p} needs frames of rows, "
                         f"cols >= {6 * (p // 2)}, got {tuple(image.shape)}")
    batch = image.shape[0] if image.ndim == 3 else 1
    plan = _plan(batch, *image.shape[-2:], mask_type, p, detect,
                 image.device)
    scratch = torch.empty(plan.nbytes, dtype=torch.uint8,
                          device=image.device)
    banks = image.index_select(-2, plan.bank_rows) if plan.wide else None
    return index, code, plan, scratch, banks


def _call(name: str, *args) -> None:
    code = getattr(build.library(), name)(*args)
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code} at launch")


def _count_analysis(plan: _Plan) -> None:
    if plan.wide:
        wide_lag_strips.launches += 1
        wide_assemble.launches += 1
        spd_solve_wide.launches += 1
    elif plan.analysis:
        me_gram_lags.launches += 1
        me_gram_assemble.launches += 1
        me_gram_solve8.launches += 1


def embed_chain(image: torch.Tensor, output: torch.Tensor,
                watermark: torch.Tensor, numerator: float, mask_type: str,
                p: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, H, W) or (H, W) f32 CUDA frames, the output they are marked into
    (their shape, or with a trailing channel axis; f32 or uint8,
    contiguous), the (H, W) f32 watermark, numerator = sf * sqrt(H * W) ->
    (marked, a new tensor like the output; strength (B,) or ()): the fused
    embed of ``ops/pipelines.py``, one call into the library. A frame whose
    solve fails keeps its pixels with a strength of 0. Another device,
    shape or dtype raises ``ValueError``."""
    span = begin("kernels.embed_chain")
    try:
        index, code, plan, scratch, banks = _prepare(image, watermark,
                                                     mask_type, p, output)
        marked = torch.empty(output.shape, dtype=output.dtype,
                             device=image.device)
        strength = torch.empty(image.shape[:-2], dtype=torch.float32,
                               device=image.device)
        base = scratch.data_ptr()
        _call("wm_embed_chain", index, image.data_ptr(), watermark.data_ptr(),
              output.data_ptr(), marked.data_ptr(), strength.data_ptr(),
              plan.batch, plan.rows, plan.cols,
              output.shape[-1] if output.ndim > image.ndim else 1,
              int(output.dtype == torch.uint8), code, p, numerator,
              plan.pred_p, *plan.analysis_args(base, banks),
              *plan.pointers(base, ("u_raw", "partials", "totals")),
              build.raw_stream(index))
        _count_analysis(plan)
        embed_field.launches += 1
        embed_field.nvf += code == MASK_CODES["nvf"]
        embed_finish.launches += 1
        embed_chain.launches += 1
        return marked, strength
    finally:
        if span:
            span.end()


def detect_chain(image: torch.Tensor, watermark: torch.Tensor,
                 mask_type: str, p: int) -> torch.Tensor:
    """(B, H, W) or (H, W) f32 CUDA frames and the (H, W) f32 watermark ->
    correlations (B,) or (): the fused detect of ``ops/pipelines.py``, one
    call into the library, 0 for a frame whose solve fails. Another device,
    shape or dtype raises ``ValueError``."""
    span = begin("kernels.detect_chain")
    try:
        index, code, plan, scratch, banks = _prepare(image, watermark,
                                                     mask_type, p)
        corr = torch.empty(image.shape[:-2], dtype=torch.float32,
                           device=image.device)
        base = scratch.data_ptr()
        _call("wm_detect_chain", index, image.data_ptr(), watermark.data_ptr(),
              corr.data_ptr(), plan.batch, plan.rows, plan.cols, code, p,
              plan.pred_p, *plan.analysis_args(base, banks),
              *plan.pointers(base, ("partials",)), build.raw_stream(index))
        _count_analysis(plan)
        detect_partials.launches += 1
        detect_partials.pipelined += pipelined(mask_type, p)
        detect_partials.nvf += code == MASK_CODES["nvf"]
        detect_chain.launches += 1
        return corr
    finally:
        if span:
            span.end()


embed_chain.launches = 0
detect_chain.launches = 0
