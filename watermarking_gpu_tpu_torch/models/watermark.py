"""The watermarking engine.

Same public contract as the JAX package's ``Watermark`` (and the
reference's, ``Watermark.hpp:26-72``): a constructor with dims, watermark,
p and psnr; ``embed`` == ``makeWatermark``; ``detect`` == ``detectWatermark``;
``reinitialize``; and ``detect_many``, identification against a bank of
candidate watermarks. The engine lives on a ``device``, the card unless the
caller asks for another; the watermark matrix is uploaded there once per
``reinitialize``. Results are tensors on that device (call ``float()`` on a
strength or correlation to read it).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..io.matfile import generate_watermark, load_watermark
from ..ops.embed import strength_factor
from ..ops.pipelines import (IMPLS, detect_many_pipeline, detect_pipeline,
                             embed_pipeline)
from ..utils.profiling import begin
from .masks import MaskType

_VALID_P = (3, 5, 7, 9)


def as_device_input(x, device: torch.device) -> torch.Tensor:
    """Move an image to ``device`` in its transfer dtype: uint8 stays uint8
    (a 4x narrower copy, widened on the device by the pipelines); anything
    else becomes f32 before the copy."""
    span = begin("engine.to_device")
    try:
        tensor = (x if isinstance(x, torch.Tensor)
                  else torch.from_numpy(np.ascontiguousarray(x)))
        if tensor.dtype != torch.uint8:
            tensor = tensor.to(torch.float32)
        return tensor.to(device)
    finally:
        if span:
            span.end()


class Watermark:
    """Embeds and detects additive spread-spectrum watermarks.

    rows, cols : image dimensions this engine is specialized for.
    watermark  : path to a raw float32 ``.dat`` file, an array of shape
                 (rows, cols), or an integer seed to generate one.
    p          : mask window size, 3, 5, 7 or 9: the NVF variance window,
                 and the ME predictor's (the reference rejects p != 3 for
                 ME; like the JAX package, ME here generalizes to the
                 (p*p-1)-tap predictor).
    psnr       : target embedding PSNR in dB (> 0).
    impl       : 'cuda' (fused route: CUDA kernels on a CUDA device, their
                 plain versions on the CPU) or 'torch' (plain formulation).
    device     : where the watermark lives and the work runs; "cuda" by
                 default (without a card, torch raises; pass "cpu" to run
                 the kernels' plain versions there).
    """

    def __init__(self, rows: int, cols: int,
                 watermark: "str | os.PathLike | np.ndarray | int",
                 p: int = 3, psnr: float = 40.0, impl: str = "cuda",
                 device: "str | torch.device" = "cuda"):
        if p not in _VALID_P:
            raise ValueError(f"Wrong p parameter: {p}!")
        if psnr <= 0:
            raise ValueError("PSNR must be a positive number")
        if impl not in IMPLS:
            raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
        self.p = p
        self.psnr = float(psnr)
        self.strength_factor = strength_factor(self.psnr)
        self.impl = impl
        self.device = torch.device(device)
        self.reinitialize(watermark, rows, cols)

    @classmethod
    def from_state(cls, state: dict, device: "str | torch.device" = "cuda",
                   impl: str = "cuda") -> "Watermark":
        """Build an engine from another engine's state as numpy:
        ``{"rows", "cols", "p", "psnr", "random_matrix"}`` (the JAX engine's
        attributes, with ``np.asarray(engine.random_matrix)``)."""
        return cls(int(state["rows"]), int(state["cols"]),
                   np.asarray(state["random_matrix"], dtype=np.float32),
                   p=int(state["p"]), psnr=float(state["psnr"]), impl=impl,
                   device=device)

    # -- state ------------------------------------------------------------

    def reinitialize(self, watermark, rows: int, cols: int) -> None:
        """Re-point the engine at a new image size / watermark matrix."""
        self.rows = int(rows)
        self.cols = int(cols)
        matrix = self._resolve_watermark(watermark).astype(np.float32)
        self.random_matrix = torch.from_numpy(
            np.ascontiguousarray(matrix)).to(self.device)

    def _resolve_watermark(self, watermark) -> np.ndarray:
        if isinstance(watermark, (str, os.PathLike)):
            return load_watermark(watermark, self.rows, self.cols)
        if isinstance(watermark, (int, np.integer)):
            return generate_watermark(self.rows, self.cols, int(watermark))
        arr = (watermark.cpu().numpy() if isinstance(watermark, torch.Tensor)
               else np.asarray(watermark))
        if arr.shape != (self.rows, self.cols):
            raise ValueError(
                f"Watermark shape {arr.shape} != image dims "
                f"({self.rows}, {self.cols})")
        return arr

    # -- public API ---------------------------------------------------------

    def warmup(self, channels: int = 0,
               mask_type: "MaskType | str | None" = None) -> None:
        """Run each mask's embed and detect once (on the card this builds
        the kernels) and wait for the device."""
        masks = ((MaskType.parse(mask_type),) if mask_type is not None
                 else (MaskType.NVF, MaskType.ME))
        gray = np.zeros((self.rows, self.cols), dtype=np.float32)
        for mask in masks:
            out = gray if channels == 0 else np.zeros(
                (self.rows, self.cols, channels), dtype=np.float32)
            self.embed(gray, out, mask)
            self.detect(gray, mask)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def embed(self, image, output=None,
              mask_type: "MaskType | str" = MaskType.ME
              ) -> tuple[torch.Tensor, torch.Tensor]:
        """Embed the watermark computed from grayscale ``image`` into
        ``output`` (default: ``image``). Returns (watermarked, strength)."""
        span = begin("engine.embed")
        try:
            mask_type = MaskType.parse(mask_type)
            self._check_dims(image)
            image = as_device_input(image, self.device)
            output = (image if output is None
                      else as_device_input(output, self.device))
            return embed_pipeline(image, output, self.random_matrix,
                                  self.strength_factor, mask_type.value,
                                  p=self.p, impl=self.impl)
        finally:
            if span:
                span.end()

    def detect(self, image,
               mask_type: "MaskType | str" = MaskType.ME) -> torch.Tensor:
        """Detector correlation of a grayscale image (0-d tensor)."""
        span = begin("engine.detect")
        try:
            mask_type = MaskType.parse(mask_type)
            self._check_dims(image)
            return detect_pipeline(as_device_input(image, self.device),
                                   self.random_matrix, mask_type.value,
                                   p=self.p, impl=self.impl)
        finally:
            if span:
                span.end()

    # Device memory one detect_many dispatch may take for its per-candidate
    # intermediates; the candidate axis is chunked to stay inside it. 8 GiB,
    # a tenth of an H100's 80 GB: the plain route (impl="torch", and the
    # kernel's plain version on CPU tensors) holds about six (B * chunk, H,
    # W) f32 planes at its peak (u, its edge-padded copy, the running error,
    # one tap's product, the next error, a product for the sums), which
    # leaves the rest of the card to the caching allocator's slack, the bank
    # and the frames in flight. chip_smoke.py reads the plain route's peak
    # on the card. The kernel route keeps no such planes (its partials are a
    # few MB), so it takes the whole bank in one dispatch.
    _DETECT_MANY_BUDGET_BYTES = 8 * 1024 ** 3
    _PLAIN_PLANES = 6

    def detect_many(self, image, watermarks,
                    mask_type: "MaskType | str" = MaskType.ME
                    ) -> torch.Tensor:
        """Watermark identification: correlations of grayscale image(s)
        against N candidate matrices. (rows, cols) image -> (N,); a
        (B, rows, cols) stack -> (B, N).

        The per-image analysis (Gram, solve, error sequence, mask) runs once
        and is shared across the candidates (the reference can only loop
        ``detectWatermark``, Watermark.cpp:234-250). Large banks are chunked
        along the candidate axis to keep the intermediates inside
        ``_DETECT_MANY_BUDGET_BYTES``; the last chunk is padded to the chunk
        size (so every dispatch has one shape and the caching allocator
        reuses its blocks) and sliced back. A bank that is already an f32
        tensor on the engine's device is used in place. The engine's own
        ``random_matrix`` is not implied: pass every candidate.
        """
        span = begin("engine.detect_many")
        try:
            mask_type = MaskType.parse(mask_type)
            if (tuple(image.shape[-2:]) != (self.rows, self.cols)
                    or len(image.shape) not in (2, 3)):
                raise ValueError(
                    f"Images must be ({self.rows}, {self.cols}) or "
                    f"(B, {self.rows}, {self.cols}), got shape "
                    f"{tuple(image.shape)}")
            if (len(watermarks.shape) != 3
                    or tuple(watermarks.shape[1:]) != (self.rows, self.cols)):
                raise ValueError(
                    f"Candidate watermarks must be (N, {self.rows}, "
                    f"{self.cols}), got shape {tuple(watermarks.shape)}")
            image = as_device_input(image, self.device)
            watermarks = as_device_input(watermarks, self.device).to(
                torch.float32)
            batch = image.shape[0] if image.ndim == 3 else 1
            n = watermarks.shape[0]
            if self.device.type == "cuda" and self.impl == "cuda":
                chunk = n   # the kernel keeps no per-candidate planes
            else:
                per_candidate = (self._PLAIN_PLANES * batch * 4 * self.rows
                                 * self.cols)
                chunk = max(1, self._DETECT_MANY_BUDGET_BYTES // per_candidate)

            def run(bank):
                return detect_many_pipeline(image, bank, mask_type.value,
                                            p=self.p, impl=self.impl)
            if chunk >= n:
                return run(watermarks)
            parts = [run(watermarks[start:start + chunk])
                     for start in range(0, n - n % chunk, chunk)]
            if n % chunk:
                tail = watermarks[n - n % chunk:]
                pad = tail[-1:].expand(chunk - tail.shape[0], -1, -1)
                parts.append(run(torch.cat([tail, pad]))[..., :tail.shape[0]])
            return torch.cat(parts, dim=-1)
        finally:
            if span:
                span.end()

    def _check_dims(self, image) -> None:
        # exact shape: an RGB (H, W, 3) array passed as the grayscale
        # analysis input would otherwise be read as extra columns
        if tuple(image.shape) != (self.rows, self.cols):
            raise ValueError(
                f"Analysis image must be grayscale ({self.rows}, "
                f"{self.cols}), got shape {tuple(image.shape)}; convert with "
                f"rgb_to_gray() or call reinitialize().")
