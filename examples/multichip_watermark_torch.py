"""Multi-card watermarking over a (data, space) mesh of CUDA devices, with
the PyTorch/CUDA port (``watermarking_gpu_tpu_torch``).

Frames shard across the ``data`` axis; each frame's rows shard across the
``space`` axis, halo rows copied between neighbouring shards. One process
drives every card, and every shard runs the port's CUDA kernels in their
halo forms (``impl="cuda"``). Run on a machine with NVIDIA GPUs:

    python examples/multichip_watermark_torch.py

``main(devices=[...])`` takes another device list; on CPU devices the
kernels' plain versions run, e.g. ``main(devices=["cpu"] * 4)``.
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from watermarking_gpu_tpu_torch.ops import strength_factor
from watermarking_gpu_tpu_torch.parallel import (make_hybrid_detect,
                                                 make_hybrid_embed, make_mesh,
                                                 make_mesh_detect_many,
                                                 shard_hybrid, shard_rows,
                                                 shard_watermark)


def main(devices=None):
    if devices is None:
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device: pass main(devices=[...]) to "
                             "run elsewhere")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    space = 2 if n % 2 == 0 and n >= 2 else 1
    data = n // space
    mesh = make_mesh(data=data, space=space, devices=devices)
    print(f"{n} devices -> mesh data={data} x space={space} "
          f"({devices[0].type})")

    batch, rows, cols = 2 * data, 64 * space, 512
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:rows, 0:cols].astype(np.float32)
    frames = np.clip(110 + 70 * np.sin(xx / 9.0) * np.cos(yy / 7.0)
                     + rng.normal(0, 14, (batch, rows, cols)), 0,
                     255).astype(np.float32)
    watermark = rng.normal(0, 1, (rows, cols)).astype(np.float32)

    frames_sharded = shard_hybrid(mesh, frames)
    wm_sharded = shard_watermark(mesh, watermark)

    sf = strength_factor(35.0)
    embed = make_hybrid_embed(mesh, "me", sf, impl="cuda")
    detect = make_hybrid_detect(mesh, "me", impl="cuda")

    marked, strengths = embed(frames_sharded, frames_sharded, wm_sharded)
    corrs = np.asarray(detect(marked, wm_sharded))
    clean = np.asarray(detect(frames_sharded, wm_sharded))
    print(f"{batch} frames of {rows}x{cols}, strength "
          f"{float(np.asarray(strengths)[0]):.3f}")
    print(f"marked correlations: {corrs.round(3)}")
    print(f"clean  correlations: {clean.round(3)}")

    # identification over the same mesh: WHICH watermark does a frame
    # carry? The candidate bank splits across `data` groups while the
    # frame's rows stay sharded over `space`.
    n_candidates = 2 * data
    bank = np.concatenate([
        watermark[None],
        rng.normal(0, 1, (n_candidates - 1, rows, cols)).astype(np.float32)])
    identify = make_mesh_detect_many(mesh, "me", impl="cuda")
    corrs_n = np.asarray(identify(shard_rows(mesh, np.asarray(marked)[0]),
                                  shard_hybrid(mesh, bank)))
    print(f"identification over {n_candidates} candidates: "
          f"argmax={int(corrs_n.argmax())} (0 = the embedded one), "
          f"margin {corrs_n[0] - np.sort(corrs_n)[-2]:.3f}")


if __name__ == "__main__":
    main()
