#!/usr/bin/env python3
"""Watermark identification on the card, with the PyTorch/CUDA port: which
of N candidate matrices does an image carry?

One ``detect_many`` dispatch correlates the image against every candidate,
sharing the image analysis (Gram, solve, error sequence, mask) across all
of them; on the card the multi-candidate kernel scores the whole bank (the
reference can only loop ``detectWatermark``, Watermark.cpp:234-250).

Usage: python examples/identify_watermark_torch.py [image.png] [n_candidates]

``main(image_path, n, device="cpu")`` runs on the CPU (the kernels' plain
versions).
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from watermarking_gpu_tpu_torch import MaskType, Watermark
from watermarking_gpu_tpu_torch.io import load_image_gray
from watermarking_gpu_tpu_torch.io.matfile import generate_watermark

SAMPLES = "Watermark_GPU/samples"


def main(image_path=None, n=16, device=None):
    """Returns {"true_index", "strength", "corrs" (N,), "best"}, the numbers
    printed; raises RuntimeError when another candidate wins."""
    if device is None:
        if not torch.cuda.is_available():
            raise SystemExit('no CUDA device: pass main(device="cpu") to '
                             'run elsewhere')
        device = "cuda"
    image_path = image_path or f"{SAMPLES}/images/512.png"
    n = int(n)

    gray = load_image_gray(image_path)
    rows, cols = gray.shape
    # one matrix per "user"; in production these come from a key registry
    candidates = np.stack([generate_watermark(rows, cols, seed=1000 + i)
                           for i in range(n)])
    true_index = n // 2

    engine = Watermark(rows, cols, candidates[true_index], p=3, psnr=40.0,
                       device=device)
    marked, strength = engine.embed(gray, mask_type=MaskType.ME)
    print(f"embedded candidate #{true_index} "
          f"(strength {float(strength):.3f})")

    corrs = engine.detect_many(marked, candidates).cpu().numpy()
    best = int(np.argmax(corrs))
    print(f"identification over {n} candidates (one dispatch):")
    for i, c in enumerate(corrs):
        tag = "  <-- identified" if i == best else ""
        print(f"  candidate {i:2d}: {c:+.4f}{tag}")
    if best != true_index:
        raise RuntimeError("identification failed")
    print("correct.")
    return {"true_index": true_index, "strength": float(strength),
            "corrs": corrs, "best": best}


if __name__ == "__main__":
    main(*sys.argv[1:3])
