#!/usr/bin/env python3
"""Minimal image embed + detect round trip on the card, with the PyTorch/CUDA
port (``watermarking_gpu_tpu_torch``).

Usage: python examples/image_watermark_torch.py [image.png] [watermark.dat]

Defaults to the reference's bundled 512^2 sample, by its path in the
reference repository (relative to the working directory). Writes the
watermarked images to ``marked_{nvf,me}.png`` in the temporary directory.
``main(image_path, wm_path, device="cpu")`` runs on the CPU (the kernels'
plain versions).
"""

import os
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from watermarking_gpu_tpu_torch import MaskType, Watermark
from watermarking_gpu_tpu_torch.io import load_image_gray, save_image_u8

SAMPLES = "Watermark_GPU/samples"


def main(image_path=None, wm_path=None, device=None, out_dir=None):
    """Returns {mask name: {"strength", "corr_marked", "corr_clean",
    "path"}}, the numbers printed."""
    if device is None:
        if not torch.cuda.is_available():
            raise SystemExit('no CUDA device: pass main(device="cpu") to '
                             'run elsewhere')
        device = "cuda"
    image_path = image_path or f"{SAMPLES}/images/512.png"
    wm_path = wm_path or f"{SAMPLES}/w_512.dat"
    out_dir = tempfile.gettempdir() if out_dir is None else out_dir

    gray = load_image_gray(image_path)
    engine = Watermark(*gray.shape, wm_path, p=3, psnr=40.0, device=device)

    results = {}
    for mask_type in (MaskType.NVF, MaskType.ME):
        marked, strength = engine.embed(gray, mask_type=mask_type)
        corr = engine.detect(marked, mask_type)
        clean = engine.detect(gray, mask_type)
        print(f"{mask_type.name}: strength={float(strength):.4f} "
              f"corr(marked)={float(corr):.6f} corr(clean)={float(clean):.6f}")
        path = os.path.join(out_dir, f"marked_{mask_type.name.lower()}.png")
        save_image_u8(path, marked.cpu().numpy())
        results[mask_type.name] = {"strength": float(strength),
                                   "corr_marked": float(corr),
                                   "corr_clean": float(clean), "path": path}
    print(f"watermarked images written to "
          f"{os.path.join(out_dir, 'marked_{nvf,me}.png')}")
    return results


if __name__ == "__main__":
    main(*sys.argv[1:3])
