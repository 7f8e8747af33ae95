"""Frame-parallel (DP) embed/detect over the ``data`` axis of a mesh.

Counterpart of the JAX package's ``parallel/data_parallel.py``. Independent
frames split over the data axis; each mesh position runs the single-device
batched pipeline (``ops/pipelines.py``) on its block, with no
communication: the per-frame solves and scalar reductions are frame-local.
With ``impl="cuda"`` every shard launches the same kernels as one device
does (the 3x3 or the wide Gram, the embed field or the detect tail, the
multi-candidate kernel), so this route covers every window. A mesh with a
space axis > 1 holds copies along it, and each position computes its own,
as ``shard_map`` does in the JAX package.
"""

from __future__ import annotations

from ..models.batched import batch_detect, batch_embed
from ..ops.pipelines import _check_args, detect_many_pipeline
from .mesh import DATA_AXIS, Mesh, Sharded, per_position, shard


def shard_frames(mesh: Mesh, frames) -> Sharded:
    """Place a (B, H, W[, C]) stack with B split over the data axis."""
    return shard(mesh, frames, (DATA_AXIS,))


def replicate(mesh: Mesh, value) -> Sharded:
    """Place a copy of ``value`` (e.g. the watermark) on every position."""
    return shard(mesh, value, ())


def make_dp_detect(mesh: Mesh, mask_type: str, p: int = 3,
                   impl: str = "cuda"):
    """Frame-sharded detect: (B, H, W) frames, (H, W) watermark -> (B,)
    correlations split over the data axis."""
    _check_args(mask_type, p, impl)

    def detect(frames, watermark) -> Sharded:
        frames = shard_frames(mesh, frames)
        watermark = replicate(mesh, watermark)
        return Sharded(mesh, (DATA_AXIS,), per_position(
            mesh, lambda i, j: batch_detect(
                frames.shards[i][j], watermark.shards[i][j], mask_type, p=p,
                impl=impl)))
    return detect


def make_dp_detect_many(mesh: Mesh, mask_type: str, p: int = 3,
                        impl: str = "cuda", batched: bool = False):
    """Candidate-sharded identification: an (H, W) image, or (B, H, W) with
    ``batched=True``, against an (N, H, W) bank split over the data axis
    -> (..., N) correlations, the candidate axis split.

    Each position runs the shared-analysis ``detect_many_pipeline`` on its
    slice of the bank: the image analysis (Gram, solve, error sequence,
    mask) is repeated per position but shared by its N/n candidates, so the
    repeated work is one detection's analysis, not N of them, and nothing
    moves between devices (the reference can only loop N full detections,
    ``Watermark.cpp:234-250``).
    """
    _check_args(mask_type, p, impl)
    out_spec = (None, DATA_AXIS) if batched else (DATA_AXIS,)

    def detect_many(image, bank) -> Sharded:
        image = replicate(mesh, image)
        bank = shard_frames(mesh, bank)
        return Sharded(mesh, out_spec, per_position(
            mesh, lambda i, j: detect_many_pipeline(
                image.shards[i][j], bank.shards[i][j], mask_type, p=p,
                impl=impl)))
    return detect_many


def make_dp_embed(mesh: Mesh, mask_type: str, strength_factor_value: float,
                  p: int = 3, impl: str = "cuda", channels: bool = False):
    """Frame-sharded embed: (B, H, W) frames, (B, H, W[, C]) outputs, (H,
    W) watermark -> (watermarked stack, (B,) strengths), both split over
    the data axis. ``channels`` does nothing: it mirrors the JAX package's
    signature, and the outputs' shape carries it."""
    del channels
    _check_args(mask_type, p, impl)

    def embed(frames, outputs, watermark) -> tuple[Sharded, Sharded]:
        frames = shard_frames(mesh, frames)
        outputs = shard_frames(mesh, outputs)
        watermark = replicate(mesh, watermark)
        results = per_position(mesh, lambda i, j: batch_embed(
            frames.shards[i][j], outputs.shards[i][j],
            watermark.shards[i][j], strength_factor_value, mask_type, p=p,
            impl=impl))
        return (Sharded(mesh, outputs.spec,
                        [[w for w, _ in row] for row in results]),
                Sharded(mesh, (DATA_AXIS,),
                        [[s for _, s in row] for row in results]))
    return embed
