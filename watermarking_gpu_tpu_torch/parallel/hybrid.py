"""Hybrid DP x SP: frames split over the ``data`` axis, each frame's rows
over the ``space`` axis.

Counterpart of the JAX package's ``parallel/hybrid.py``: the full mesh
step. Within a space row the halos and scalar reductions move between the
shards (``parallel.spatial``); across data rows frames are independent. The
shard functions are batch-polymorphic, so each position processes its
(B_local, h_local, W) block, and collectives run over the space axis
only. ``impl="cuda"`` runs the kernels' halo forms on every shard, as the
spatial route does.
"""

from __future__ import annotations

from ..ops.pipelines import _check_args
from .mesh import DATA_AXIS, SPACE_AXIS, Mesh, Sharded, shard
from .spatial import _detect_many_shard, _detect_shard, _embed_shard


def shard_hybrid(mesh: Mesh, frames) -> Sharded:
    """Place (B, H, W) frames with B over data and H over space."""
    return shard(mesh, frames, (DATA_AXIS, SPACE_AXIS))


def shard_watermark(mesh: Mesh, watermark) -> Sharded:
    """Row-split the (H, W) watermark over the space axis (copies on every
    data row)."""
    return shard(mesh, watermark, (SPACE_AXIS,))


def make_hybrid_detect(mesh: Mesh, mask_type: str, p: int = 3,
                       impl: str = "cuda"):
    """(B, H, W) frames + (H, W) watermark -> (B,) correlations split over
    the data axis. ``impl="cuda"`` runs the kernels' halo forms at every
    mask and p, ``impl="torch"`` the plain ops."""
    _check_args(mask_type, p, impl)

    def detect(frames, watermark) -> Sharded:
        frames = shard_hybrid(mesh, frames)
        watermark = shard_watermark(mesh, watermark)
        return Sharded(mesh, (DATA_AXIS,), [
            _detect_shard(frames.row(i), watermark.row(i), mask_type, p,
                          impl) for i in range(mesh.shape[DATA_AXIS])])
    return detect


def make_hybrid_embed(mesh: Mesh, mask_type: str,
                      strength_factor_value: float, p: int = 3,
                      impl: str = "cuda"):
    """(B, H, W) frames, (B, H, W) outputs, (H, W) watermark ->
    (watermarked (B, H, W) split as the frames, strengths (B,) over data).
    The JAX package's ``rows`` and ``cols`` arguments are not taken: the
    frames' shape carries them."""
    _check_args(mask_type, p, impl)

    def embed(frames, outputs, watermark) -> tuple[Sharded, Sharded]:
        frames = shard_hybrid(mesh, frames)
        outputs = shard_hybrid(mesh, outputs)
        watermark = shard_watermark(mesh, watermark)
        per_row = [_embed_shard(frames.row(i), outputs.row(i),
                                watermark.row(i), strength_factor_value,
                                mask_type, p, impl)
                   for i in range(mesh.shape[DATA_AXIS])]
        return (Sharded(mesh, outputs.spec,
                        [[w for w, _ in row] for row in per_row]),
                Sharded(mesh, (DATA_AXIS,),
                        [[s for _, s in row] for row in per_row]))
    return embed


def make_mesh_detect_many(mesh: Mesh, mask_type: str, p: int = 3,
                          impl: str = "cuda", batched: bool = False):
    """Identification over the whole mesh: an (H, W) image, or (B, H, W)
    with ``batched=True``, against an (N, H, W) bank -> (..., N)
    correlations, the image's and the candidates' rows split over space and
    the candidates over data.

    Frames too large for one device split their rows (halo exchange and
    psum'd reductions, as detection does) and the bank splits over the data
    rows with no collectives; each position runs the shared-analysis shard
    function (``spatial._detect_many_shard``). With data=1 this is purely
    spatial identification, with space=1 purely candidate-parallel (see
    ``make_dp_detect_many``). ``impl="cuda"`` runs the Gram's and the
    multi-candidate kernel's halo forms on every shard (the single-device
    kernels where the space axis has one shard).
    """
    _check_args(mask_type, p, impl)
    img_spec = (None, SPACE_AXIS) if batched else (SPACE_AXIS,)
    out_spec = (None, DATA_AXIS) if batched else (DATA_AXIS,)

    def detect_many(image, bank) -> Sharded:
        image = shard(mesh, image, img_spec)
        bank = shard_hybrid(mesh, bank)
        return Sharded(mesh, out_spec, [
            _detect_many_shard(image.row(i), bank.row(i), mask_type, p, impl)
            for i in range(mesh.shape[DATA_AXIS])])
    return detect_many
