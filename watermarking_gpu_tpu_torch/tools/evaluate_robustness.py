"""Detector robustness evaluation under common attacks, on the card.

Embeds a watermark, applies an attack family (additive noise, JPEG
recompression, u8 quantization, brightness scaling) and reports detector
correlations. Counterpart of the JAX package's
``tools/evaluate_robustness.py``, with its arguments, attacks, random
stream and lines: the batched engine detects every attacked frame in one
dispatch.

    python -m watermarking_gpu_tpu_torch.tools.evaluate_robustness \
        [image.png] [--psnr 40] [--mask me] [--p 3] [--seed 28390211]

The JPEG attack is Pillow's libjpeg encode and decode, as in the JAX tool.
Where Pillow does not import, each ``jpeg q=...`` row prints as skipped and
the batch holds the other attacks: a stand-in codec would be another
attack, with other correlations.
"""

from __future__ import annotations

import argparse
import io
import sys

import numpy as np
import torch

from ..io import load_image_gray
from ..io.matfile import generate_watermark
from ..models import BatchedWatermark
from . import resolve_device

# the reference's bundled sample, by its path in the reference repository
# (relative to the working directory)
DEFAULT_IMAGE = "Watermark_GPU/samples/images/512.png"
NOISE_SIGMAS = (2, 5, 10, 20)
JPEG_QUALITIES = (90, 70, 50, 30)
BRIGHTNESS_SCALES = (0.9, 1.1)
JPEG_SKIPPED = "skipped (Pillow is not installed)"


def jpeg_roundtrip(gray: np.ndarray, quality: int) -> np.ndarray:
    """Pillow's JPEG encode then decode of a u8 cast of ``gray``; raises
    ImportError without Pillow."""
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(gray.astype(np.uint8)).save(buf, format="JPEG",
                                                quality=quality)
    buf.seek(0)
    return np.asarray(Image.open(buf), dtype=np.float32)


def attacks(marked: np.ndarray, gray: np.ndarray,
            rng: np.random.Generator
            ) -> list[tuple[str, np.ndarray | None]]:
    """(name, attacked frame) in the JAX tool's order; the JPEG rows' frame
    is None where Pillow does not import. The noise is drawn from ``rng``
    before any JPEG row, so skipping them changes no other frame."""
    out: list[tuple[str, np.ndarray | None]] = [
        ("none", marked), ("clean image (no mark)", gray)]
    for sigma in NOISE_SIGMAS:
        noisy = np.clip(marked + rng.normal(0, sigma, marked.shape), 0, 255)
        out.append((f"gaussian noise sigma={sigma}",
                    noisy.astype(np.float32)))
    # numpy's cast truncates, as the JAX tool's does
    out.append(("u8 quantization",
                marked.astype(np.uint8).astype(np.float32)))
    for quality in JPEG_QUALITIES:
        try:
            frame = jpeg_roundtrip(np.clip(marked, 0, 255), quality)
        except ImportError:
            frame = None
        out.append((f"jpeg q={quality}", frame))
    for scale in BRIGHTNESS_SCALES:
        out.append((f"brightness x{scale}",
                    np.clip(marked * scale, 0, 255).astype(np.float32)))
    return out


def main(argv: list[str] | None = None,
         device: "str | torch.device | None" = None,
         results: dict | None = None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("image", nargs="?", default=DEFAULT_IMAGE)
    parser.add_argument("--psnr", type=float, default=40.0)
    parser.add_argument("--mask", choices=["me", "nvf"], default="me")
    parser.add_argument("--p", type=int, default=3, choices=[3, 5, 7, 9],
                        help="mask window (ME p>3 runs the generalized "
                             "predictor, an extension of the reference)")
    parser.add_argument("--seed", type=int, default=28390211)
    args = parser.parse_args(argv)
    device = resolve_device(device)
    if device is None:
        return 1

    try:
        gray = load_image_gray(args.image)
    except FileNotFoundError:
        print(f"Could not load {args.image} file", file=sys.stderr)
        return 1
    rows, cols = gray.shape
    watermark = generate_watermark(rows, cols, args.seed)
    engine = BatchedWatermark(rows, cols, watermark, p=args.p,
                              psnr=args.psnr, device=device)

    marked_batch, strength = engine.embed(gray[None], mask_type=args.mask)
    marked = marked_batch[0].cpu().numpy()
    strength = float(strength[0])
    print(f"image {args.image} ({rows}x{cols}), mask={args.mask}, "
          f"p={args.p}, psnr={args.psnr}, strength={strength:.4f}\n")

    rows_out = attacks(marked, gray, np.random.default_rng(0))
    ran = [frame for _, frame in rows_out if frame is not None]
    corrs = iter(engine.detect(np.stack(ran), args.mask).cpu().numpy())
    table = [(name, None if frame is None else float(next(corrs)))
             for name, frame in rows_out]
    width = max(len(name) for name, _ in table)
    print(f"{'attack'.ljust(width)}  correlation")
    for name, corr in table:
        print(f"{name.ljust(width)}  "
              f"{JPEG_SKIPPED if corr is None else f'{corr:+.4f}'}")
    if results is not None:
        results.update(strength=strength, marked=marked, rows=table,
                       batch=len(ran))
    return 0


if __name__ == "__main__":
    sys.exit(main())
