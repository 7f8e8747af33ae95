#!/usr/bin/env python3
"""Video embed + detect on a synthetic raw .yuv clip (no ffmpeg required),
on the card, with the PyTorch/CUDA port.

Usage: python examples/video_watermark_torch.py

``main(device="cpu")`` runs on the CPU (the kernels' plain versions).
"""

import os
import shutil
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from watermarking_gpu_tpu_torch.io.config import Settings
from watermarking_gpu_tpu_torch.io.matfile import (generate_watermark,
                                                   save_watermark)
from watermarking_gpu_tpu_torch.video import (detect_video, embed_video,
                                              synthesize)

W, H, FRAMES, INTERVAL = 640, 360, 60, 10


def main(device=None):
    """Returns {"marked": [(frame, corr)], "clean": [(frame, corr)]}, the
    per-frame correlations printed."""
    if device is None:
        if not torch.cuda.is_available():
            raise SystemExit('no CUDA device: pass main(device="cpu") to '
                             'run elsewhere')
        device = "cuda"
    root = tempfile.mkdtemp(prefix="wm_video_")
    try:
        clip = os.path.join(root, "clip.yuv")
        with open(clip, "wb") as f:
            f.write(synthesize(W, H, FRAMES, seed=7))
        wm_path = os.path.join(root, "w.dat")
        save_watermark(wm_path, generate_watermark(H, W, 28390211))

        common = dict(watermark=wm_path, p=3, psnr=38.0,
                      watermark_interval=INTERVAL,
                      raw_video_size=f"{W}x{H}", raw_video_fps=30.0)

        marked = os.path.join(root, "marked.yuv")
        embed_video(Settings(video=clip, encode_watermark_file_path=marked,
                             **common), device=device)

        print("\n-- detection on the watermarked clip --")
        _, marked_corrs = detect_video(
            Settings(video=marked, detect_batch=4, **common), device=device)

        print("\n-- detection on the clean clip (should be ~0) --")
        _, clean_corrs = detect_video(
            Settings(video=clip, detect_batch=4, **common), device=device)
    finally:
        shutil.rmtree(root)
    return {"marked": marked_corrs, "clean": clean_corrs}


if __name__ == "__main__":
    main()
