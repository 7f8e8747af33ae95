#!/usr/bin/env python3
"""Batching detector service demo on the card, with the PyTorch/CUDA port:
submit frames, collect futures.

Usage: python examples/serving_demo_torch.py

``main(device="cpu")`` runs on the CPU (the kernels' plain versions).
"""

import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from watermarking_gpu_tpu_torch import (BatchedWatermark, DetectorService,
                                        EmbedderService, IdentifierService)

H, W, N = 360, 640, 32


def main(device=None):
    """Returns {"seconds", "corrs" (one a frame), "scores" (N,),
    "identified"}, the numbers printed."""
    if device is None:
        if not torch.cuda.is_available():
            raise SystemExit('no CUDA device: pass main(device="cpu") to '
                             'run elsewhere')
        device = "cuda"
    rng = np.random.default_rng(0)
    wm = rng.normal(size=(H, W)).astype(np.float32)
    frames = np.clip(rng.normal(128, 40, (N, H, W)), 0,
                     255).astype(np.float32)
    engine = BatchedWatermark(H, W, wm, p=3, psnr=35.0, device=device)

    embedder = EmbedderService(engine, batch_size=8)
    detector = DetectorService(engine, batch_size=8)
    try:
        t0 = time.perf_counter()
        marked = [f.result()[0]
                  for f in [embedder.submit(x) for x in frames]]
        corrs = [f.result()
                 for f in [detector.submit(m) for m in marked]]
        dt = time.perf_counter() - t0
        print(f"{N} frames embed+detect in {dt:.2f}s "
              f"({N / dt:.1f} fps end-to-end incl. transfers)")
        print(f"correlations: min {min(corrs):.3f} max {max(corrs):.3f}")
    finally:
        embedder.close()
        detector.close()

    # identification: which candidate does a frame carry? (the engine's
    # own matrix is candidate 0 among decoys)
    bank = np.stack([wm] + [rng.normal(size=(H, W)).astype(np.float32)
                            for _ in range(7)])
    identifier = IdentifierService(engine, bank, batch_size=8)
    try:
        scores = identifier.submit(marked[0]).result()
        identified = int(np.argmax(scores))
        print(f"identified candidate {identified} "
              f"(scores: {np.round(scores, 3)})")
    finally:
        identifier.close()
    return {"seconds": dt, "corrs": corrs, "scores": scores,
            "identified": identified}


if __name__ == "__main__":
    main()
