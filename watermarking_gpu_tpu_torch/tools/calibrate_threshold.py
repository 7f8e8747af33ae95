"""Detection-threshold calibration for a target false-positive rate, on the
card.

The detector outputs a correlation; deploying it needs a decision
threshold. This tool estimates the null distribution (correlations of
UNMARKED images against random candidate matrices: one ``detect_many``
dispatch scores every image against the whole candidate bank) and the
signal distribution (each image embedded with its own matrix at the
configured PSNR), then reports the Gaussian-tail threshold for the
requested FPR and the measured margins. Counterpart of the JAX package's
``tools/calibrate_threshold.py``, with its arguments, seeds and lines, and
one more line: the host's time to generate the matrices, the bank's upload
and the null dispatch.

    python -m watermarking_gpu_tpu_torch.tools.calibrate_threshold \
        [image.png] [--mask me] [--p 3] [--psnr 40] [--images 8] \
        [--nulls 256] [--fpr 1e-6]          # --fpr must lie in (0, 0.5)

The images and the bank go to the device once, as f32 (a bank of 256 x
1080 x 1920 is 2.12 GB), and the kernel route scores them in one dispatch;
each result comes back to the host once.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..io import load_image_gray
from ..io.matfile import generate_watermark
from ..models import Watermark
from . import resolve_device, timed_ms

# the reference's bundled sample, by its path in the reference repository
# (relative to the working directory)
DEFAULT_IMAGE = "Watermark_GPU/samples/images/512.png"


def _z_for(fpr: float) -> float:
    """Exact Gaussian upper-tail quantile: threshold = mean + z * std."""
    if not 0.0 < fpr < 0.5:
        raise SystemExit(f"--fpr must be in (0, 0.5), got {fpr}")
    from statistics import NormalDist
    return NormalDist().inv_cdf(1.0 - fpr)


def synthesize_variants(base: np.ndarray, count: int,
                        rng: np.random.Generator) -> np.ndarray:
    """Independent-ish test images from one sample: noise + brightness
    jitter (the detector's null distribution is driven by image content
    statistics, so variants beat reusing one image verbatim)."""
    out = []
    for _ in range(count):
        scale = rng.uniform(0.85, 1.15)
        noisy = base * scale + rng.normal(0, 6.0, base.shape)
        out.append(np.clip(noisy, 0, 255).astype(np.float32))
    return np.stack(out)


def main(argv: list[str] | None = None,
         device: "str | torch.device | None" = None,
         results: dict | None = None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("image", nargs="?", default=DEFAULT_IMAGE)
    parser.add_argument("--mask", choices=["me", "nvf"], default="me")
    parser.add_argument("--p", type=int, default=3, choices=[3, 5, 7, 9])
    parser.add_argument("--psnr", type=float, default=40.0)
    parser.add_argument("--images", type=int, default=8,
                        help="test-image variants for both distributions")
    parser.add_argument("--nulls", type=int, default=256,
                        help="random candidate matrices per image; these "
                             "are the iid axis of the null estimate, so "
                             "more candidates tighten the tail")
    parser.add_argument("--fpr", type=float, default=1e-6,
                        help="target false-positive rate")
    args = parser.parse_args(argv)
    z = _z_for(args.fpr)
    device = resolve_device(device)
    if device is None:
        return 1

    rng = np.random.default_rng(7)
    try:
        base = load_image_gray(args.image)
    except FileNotFoundError:
        print(f"Could not load {args.image} file", file=sys.stderr)
        return 1
    rows, cols = base.shape
    images = synthesize_variants(base, args.images, rng)

    start = time.perf_counter()
    candidates = np.stack([generate_watermark(rows, cols, seed=50_000 + i)
                           for i in range(args.nulls)])
    marks = [generate_watermark(rows, cols, seed=90_000 + i)
             for i in range(args.images)]
    host_s = time.perf_counter() - start
    engine = Watermark(rows, cols, candidates[0], p=args.p, psnr=args.psnr,
                       device=device)
    engine.warmup(mask_type=args.mask)   # on the card: the kernels' build
    (images_d, bank), upload_ms = timed_ms(
        lambda: (torch.from_numpy(images).to(device),
                 torch.from_numpy(candidates).to(device)), device)

    # Null: unmarked images vs every candidate (none embedded), one
    # dispatch for the whole (images, candidates) matrix
    nulls_d, null_ms = timed_ms(
        lambda: engine.detect_many(images_d, bank, args.mask), device)
    nulls_2d = nulls_d.cpu().numpy()

    # Signal: each image embedded with its own matrix, detected against it
    signals = []
    for img, wm in zip(images_d, marks):
        engine.reinitialize(wm, rows, cols)
        marked, _ = engine.embed(img, mask_type=args.mask)
        signals.append(engine.detect(marked, args.mask))
    signals = torch.stack(signals).cpu().numpy().astype(np.float64)

    # Statistics: candidates are iid, image variants are correlated (they
    # share the base image), so the iid axis is the candidate bank: use
    # the WORST per-image spread, not the pooled std over images*nulls
    # (pooling overstates the effective sample count).
    per_image_std = nulls_2d.std(axis=1, ddof=1)
    mu = float(nulls_2d.mean())
    sigma = float(per_image_std.max())
    threshold = mu + z * sigma
    misses = int((signals <= threshold).sum())

    print(f"geometry {rows}x{cols}, mask={args.mask}, p={args.p}, "
          f"psnr={args.psnr}")
    print(f"null: {args.images} images x {args.nulls} candidates  "
          f"mean={mu:+.5f}  per-image std "
          f"{float(per_image_std.min()):.5f}..{sigma:.5f}  "
          f"max={float(nulls_2d.max()):+.5f}")
    print(f"threshold @ FPR {args.fpr:g} (z={z:.2f}, Gaussian-tail "
          f"extrapolation from {args.nulls} iid candidates/image; "
          f"widen --nulls for tighter tails): {threshold:+.5f}")
    print(f"signal: n={signals.size}  mean={float(signals.mean()):+.4f}  "
          f"min={float(signals.min()):+.4f}")
    print(f"margin (signal min - threshold): "
          f"{float(signals.min()) - threshold:+.4f}"
          f"{'' if misses == 0 else f'  ({misses} MISSES)'}")
    clock = ("CUDA events, " + torch.cuda.get_device_name(device)
             if device.type == "cuda" else f"host clock, {device}")
    print(f"time: {args.nulls + args.images} matrices generated on the "
          f"host in {host_s:.3f} s; images and bank uploaded "
          f"({(images.nbytes + candidates.nbytes) / 1e9:.2f} GB) in "
          f"{upload_ms:.1f} ms; null "
          f"dispatch ({args.images} x {args.nulls}) {null_ms:.3f} ms "
          f"({clock})")
    if results is not None:
        results.update(
            nulls=nulls_2d, per_image_std=per_image_std, mean=mu,
            std_min=float(per_image_std.min()), std_max=sigma,
            max=float(nulls_2d.max()), z=z, threshold=threshold,
            signals=signals, signal_mean=float(signals.mean()),
            signal_min=float(signals.min()), misses=misses, host_s=host_s,
            upload_ms=upload_ms, null_ms=null_ms)
    return 0 if misses == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
