"""Spatially-sharded (SP) embed/detect over the ``space`` axis of a mesh.

Counterpart of the JAX package's ``parallel/spatial.py``. A frame's rows
split over the space axis; the stencils read their neighbours' edge rows,
so each step moves a row halo between neighbouring shards
(``exchange_row_halo``, ``collectives.shift``), and the frame's own top and
bottom rows are replicated at the outer shards, which keeps the frame's
clamp-to-edge semantics. Global scalars (norms, correlations, the ME
mask's max) reduce with ``collectives.psum`` / ``pmax``. The Gram folds
once (``collectives.fold``) and its system is solved once a space row, on
its first shard's device; the coefficients then go to every shard.

A per-shard program here takes the list of a space row's shards (in shard
order, each on its device) and returns a list of per-shard results: a
Python loop over the shards queues each one's work on its device, and no
value is read on the host before the caller reads the result. Every shard
function is batch-polymorphic over leading dims, so the hybrid DP x SP path
(``parallel.hybrid``) calls the same functions on (B_local, h_local, W)
blocks.

Two routes per shard:

* ``impl="torch"``: the plain ops on each shard (the JAX package's
  ``impl="xla"`` shard functions): per-shard Gram terms summed and one
  solve (the lag form with boundary banks from the edge shards
  for the wide windows, ``_gram_wide_sharded``), the error sequence and
  mask from exchanged halos, u's halo exchanged in turn for e_u.
* ``impl="cuda"``: the kernels' halo forms on each shard (the JAX
  package's ``impl="pallas"`` shard functions, whose exchanged rows sit
  where the kernels' padding would): the 3x3 Gram of the shard's owned
  rows, summed, and the embed field or the detect tail, whose u ring is
  clamped only at the frame's own top and bottom (``row_start``,
  ``total_rows``). On CPU tensors the kernels' plain halo forms run. ME at
  p > 3 and identification need the sharded wide Gram and the sharded
  multi-candidate kernel, which have no halo form yet: with more than one
  space shard they raise ``NotImplementedError`` (``impl="torch"`` runs
  them); on a space axis of one shard they run the single-device kernels.
"""

from __future__ import annotations

import math

import torch

from ..ops.cuda import detect_partials, embed_field, me_gram
from ..ops.cuda.fused import predictor_p, stencil_reach
from ..ops.me import (assemble_banks, edge_windows, gram_direct,
                      lag_partials_plain, prediction_error,
                      solve_coefficients, solve_coefficients_spd,
                      solve_coefficients_spd_wide, wide_lag_geometry)
from ..ops.nvf import nvf_mask
from ..ops.pipelines import (_check_args, _fused_analysis, _gate, _to_f32,
                             detect_many_pipeline)
from .collectives import broadcast, fold, pmax, psum, shift
from .mesh import DATA_AXIS, SPACE_AXIS, Mesh, Sharded, shard

Shards = list[torch.Tensor]


def exchange_row_halo(shards: Shards, halo: int) -> Shards:
    """Extend each (..., h, W) row shard of a space row to (..., h + 2 halo,
    W) with its neighbours' rows.

    Interior seams receive the true adjacent rows from the neighbouring
    shards; the frame's top and bottom replicate its edge row, matching the
    reference's CLAMP_TO_EDGE sampler. A halo deeper than a shard gathers
    whole neighbour blocks over several hops (blocks past the mesh's ends
    lie outside the frame and clamp to its edge rows, which the edge shards
    send to all), so every shard height works; deep halos take more
    copies.
    """
    if halo == 0:
        return list(shards)
    n = len(shards)
    h_local = shards[0].shape[-2]

    def rows_of(row: torch.Tensor, count: int, like: torch.Tensor):
        return row.expand(*like.shape[:-2], count, like.shape[-1])

    if halo <= h_local:
        from_up = shift([x[..., -halo:, :] for x in shards], 1)
        from_down = shift([x[..., :halo, :] for x in shards], -1)
        return [torch.cat([
            up if up is not None else rows_of(x[..., :1, :], halo, x), x,
            down if down is not None else rows_of(x[..., -1:, :], halo, x)],
            dim=-2) for x, up, down in zip(shards, from_up, from_down)]

    hops = -(-halo // h_local)
    devices = [x.device for x in shards]
    row0 = broadcast(shards[0][..., :1, :], devices)
    row_last = broadcast(shards[-1][..., -1:, :], devices)
    tops: list[Shards] = [[] for _ in shards]
    bottoms: list[Shards] = [[] for _ in shards]
    for j in range(1, hops + 1):
        from_up, from_down = shift(shards, j), shift(shards, -j)
        for i, x in enumerate(shards):
            tops[i].insert(0, from_up[i] if from_up[i] is not None
                           else rows_of(row0[i], h_local, x))
            bottoms[i].append(from_down[i] if from_down[i] is not None
                              else rows_of(row_last[i], h_local, x))
    start = hops * h_local - halo
    return [torch.cat(top + [x] + bottom, dim=-2)[
        ..., start:start + h_local + 2 * halo, :]
        for x, top, bottom in zip(shards, tops, bottoms)]


def _flat(x: torch.Tensor) -> torch.Tensor:
    """(..., H, W) -> contiguous (B, H, W) for the kernels' batch grid."""
    return x.reshape((-1,) + x.shape[-2:]).contiguous()


def _error_local(xs: Shards, coefficients: Shards, p: int) -> Shards:
    """Each shard's prediction error, its neighbours' rows exchanged."""
    h = p // 2
    return [prediction_error(e, c, p, h, h)
            for e, c in zip(exchange_row_halo(xs, h), coefficients)]


def _nvf_local(xs: Shards, p: int) -> Shards:
    h = p // 2
    return [nvf_mask(e, p, h, h) for e in exchange_row_halo(xs, h)]


def _gram_wide_sharded(imgs: Shards, p: int) -> torch.Tensor:
    """The frame's wide-window Gram (..., k+1, k+1) on the first shard's
    device, from per-shard lag partials summed there and one assembly.

    The single-device lag form (``ops.me.lag_partials_plain`` and
    ``assemble_banks``) splits over row shards: each lag's lane partials
    are a sum over the frame's rows, so the shards' partials over their own
    rows (with a 2h-row halo below for the lag reach) sum to the frame's,
    and the boundary-row corrections read only the frame's edge rows: the
    banks [-h, 3h) and [H-h, H+3h), which the first and last shard
    hold. Shards shorter than 3h take their bank rows from a 3h-row
    exchanged halo (several hops where a shard is shorter still).
    """
    h = p // 2
    lead = imgs[0].shape[:-2]
    h_local, cols = imgs[0].shape[-2:]
    partials = fold([lag_partials_plain(_flat(e), p, 2 * h, 2 * h)
                     for e in exchange_row_halo(imgs, 2 * h)])
    device = partials.device
    flat = [x.reshape(-1, h_local, cols) for x in imgs]
    bank_cols = torch.arange(-3 * h, cols + 3 * h).clamp(0, cols - 1)
    if h_local >= 3 * h:
        bank = torch.arange(-h, 3 * h, device=device)
        low = flat[0][:, bank.clamp(0, h_local - 1)]
        high = flat[-1][:, (h_local + bank.to(flat[-1].device)).clamp(
            0, h_local - 1)]
    else:
        # shard 0's row t of a 3h halo exchange is the frame's row t - 3h,
        # the last shard's is the frame's row (rows - h_local) + t - 3h
        ext = exchange_row_halo(flat, 3 * h)
        low = ext[0][:, 2 * h:6 * h]
        high = ext[-1][:, 2 * h + h_local:6 * h + h_local]
    low = low[..., bank_cols.to(device)]
    high = high.to(device, non_blocking=True)[..., bank_cols.to(device)]
    k = p * p
    return assemble_banks(edge_windows(partials, h), low, high, p).reshape(
        lead + (k, k))


def _solve_once(gram: torch.Tensor, solve, devices: list[torch.device]):
    """Solve the frame's system from its Gram once, on the Gram's device:
    the (coefficients, valid) pair on each of ``devices``."""
    k = gram.shape[-1] - 1
    coefficients, valid = solve(gram[..., :k, :k], gram[..., :k, k])
    return list(zip(broadcast(coefficients, devices),
                    broadcast(valid, devices)))


def _analysis_local(imgs: Shards, p: int = 3):
    """The frame's Rx/rx from per-shard partials summed on the first
    shard, then one solve: a (coefficients, valid) pair on every shard. The wide windows
    take the sharded lag form where the frame has the single-device lag
    form's geometry (``wide_lag_geometry``), the direct per-pair sums over
    each shard's rows (p//2-row halo) elsewhere and at p=3."""
    h = p // 2
    h_local, cols = imgs[0].shape[-2:]
    if wide_lag_geometry(len(imgs) * h_local, cols, p):
        gram = _gram_wide_sharded(imgs, p)
    else:
        gram = fold([gram_direct(e, p, h, h)
                     for e in exchange_row_halo(imgs, h)])
    solve = solve_coefficients if p == 3 else solve_coefficients_spd_wide
    return _solve_once(gram, solve, [x.device for x in imgs])


def _analysis_and_mask(imgs: Shards, mask_type: str, p: int):
    """The plain shard analysis shared by detection and identification:
    (pred_p, coefficients, valid, e_z, mask), all but pred_p per shard.
    The ME mask divides by the frame's max |e_z| (pmax)."""
    pred_p = predictor_p(mask_type, p)
    solved = _analysis_local(imgs, pred_p)
    coefficients = [c for c, _ in solved]
    valid = [v for _, v in solved]
    e_z = _error_local(imgs, coefficients, pred_p)
    if mask_type == "me":
        top = pmax([e.abs().amax(dim=(-2, -1), keepdim=True) for e in e_z])
        mask = [e.abs() / m for e, m in zip(e_z, top)]
    else:
        mask = _nvf_local(imgs, p)
    return pred_p, coefficients, valid, e_z, mask


def _require_kernel_route(n_space: int, mask_type: str, p: int, impl: str,
                          many: bool = False) -> None:
    """Raise where ``impl="cuda"`` needs a kernel's halo form that the port
    does not have yet (more than one space shard)."""
    if impl != "cuda" or n_space == 1:
        return
    if many:
        raise NotImplementedError(
            "identification over more than one space shard with "
            "impl='cuda' needs the sharded multi-candidate kernel (a halo "
            "form of csrc/detect_many.cu), which is not ported yet; "
            "impl='torch' runs it")
    if mask_type == "me" and p != 3:
        raise NotImplementedError(
            f"ME at p={p} over more than one space shard with impl='cuda' "
            f"needs the sharded wide Gram (a halo form of "
            f"csrc/me_gram_wide.cu), which is not ported yet; impl='torch' "
            f"runs it")


def _solve_cuda(imgs: Shards, ext: Shards, halo: int, pred_p: int):
    """(coefficients (B, k), valid (B,)) on every shard through the
    kernels: the 3x3 Gram's halo form over each shard's owned rows (``ext``
    holds ``halo`` >= 1 rows each side), summed on the first shard, and
    the unrolled Cholesky once; the wide Gram on a space axis of one
    shard."""
    if pred_p != 3:
        return [_fused_analysis(_flat(x), pred_p) for x in imgs]
    h_local = imgs[0].shape[-2]
    gram = fold([me_gram(e, halo, halo, i * h_local, len(imgs) * h_local)
                 for i, e in enumerate(ext)])
    return _solve_once(gram, solve_coefficients_spd, [x.device for x in imgs])


def _detect_shard_cuda(imgs: Shards, wms: Shards, mask_type: str,
                       p: int) -> Shards:
    """Per shard: the Gram and the detect tail in their halo forms, the
    image and the watermark extended by ``stencil_reach`` rows (the u
    ring's rows at a seam are the neighbour's true rows; the tail clamps
    the ring only at the frame's own top and bottom), then psum'd sums."""
    _require_kernel_route(len(imgs), mask_type, p, "cuda")
    h_local = imgs[0].shape[-2]
    batch_shape = imgs[0].shape[:-2]
    total_rows = len(imgs) * h_local
    halo = stencil_reach(mask_type, p)
    ext = [_flat(e) for e in exchange_row_halo(imgs, halo)]
    wm_ext = [w.contiguous() for w in exchange_row_halo(wms, halo)]
    solved = _solve_cuda(imgs, ext, halo, predictor_p(mask_type, p))
    sums = [detect_partials(e, w, c, mask_type, p, halo, halo, i * h_local,
                            total_rows)
            for i, (e, w, (c, _)) in enumerate(zip(ext, wm_ext, solved))]
    dot, norm_u, norm_z = (psum([s[m] for s in sums]) for m in range(3))
    return [torch.where(v, d / torch.sqrt(u * z), 0.0).reshape(batch_shape)
            for (_, v), d, u, z in zip(solved, dot, norm_u, norm_z)]


def _detect_shard(imgs: Shards, wms: Shards, mask_type: str, p: int,
                  impl: str = "cuda") -> Shards:
    """Correlations (...,) of row-sharded frames against the row-sharded
    watermark, on every shard."""
    imgs = [_to_f32(x) for x in imgs]
    wms = [_to_f32(w) for w in wms]
    if impl == "cuda":
        return _detect_shard_cuda(imgs, wms, mask_type, p)
    pred_p, coefficients, valid, e_z, mask = _analysis_and_mask(
        imgs, mask_type, p)
    e_u = _error_local([m * w for m, w in zip(mask, wms)], coefficients,
                       pred_p)
    dims = (-2, -1)
    dot = psum([(a * b).sum(dim=dims) for a, b in zip(e_u, e_z)])
    norm_u = psum([(a * a).sum(dim=dims) for a in e_u])
    norm_z = psum([(b * b).sum(dim=dims) for b in e_z])
    return [torch.where(v, d / torch.sqrt(u * z), 0.0)
            for v, d, u, z in zip(valid, dot, norm_u, norm_z)]


def _detect_many_shard(imgs: Shards, watermarks: Shards, mask_type: str,
                       p: int, impl: str = "cuda") -> Shards:
    """Identification per shard: (..., h_local, W) image rows x (N_local,
    h_local, W) candidate rows -> (..., N_local) correlations on every
    shard. The image analysis (Gram summed, one solve, error
    sequence, mask) runs once per shard and serves all its candidates; row
    reductions psum over the space axis, the candidate axis needs no
    collectives. ``impl="cuda"`` runs ``detect_many_pipeline``'s kernels on
    a space axis of one shard and raises on more (module docstring)."""
    imgs = [_to_f32(x) for x in imgs]
    watermarks = [_to_f32(w) for w in watermarks]
    if impl == "cuda":
        _require_kernel_route(len(imgs), mask_type, p, impl, many=True)
        return [detect_many_pipeline(imgs[0], watermarks[0], mask_type, p,
                                     impl="cuda")]
    pred_p, coefficients, valid, e_z, mask = _analysis_and_mask(
        imgs, mask_type, p)
    e_u = _error_local([m[..., None, :, :] * w
                        for m, w in zip(mask, watermarks)],
                       [c[..., None, :] for c in coefficients], pred_p)
    dims = (-2, -1)
    dot = psum([(a * b[..., None, :, :]).sum(dim=dims)
                for a, b in zip(e_u, e_z)])
    norm_u = psum([(a * a).sum(dim=dims) for a in e_u])
    norm_z = psum([(b * b).sum(dim=dims) for b in e_z])
    return [torch.where(v[..., None], d / torch.sqrt(u * z[..., None]), 0.0)
            for v, d, u, z in zip(valid, dot, norm_u, norm_z)]


def _finish_embed(u: torch.Tensor, scale: torch.Tensor, strength,
                  valid: torch.Tensor, output: torch.Tensor):
    """clamp(output + u * scale) where the solve held, else output."""
    addend = u * scale[..., None, None]
    if output.ndim == u.ndim + 1:
        addend = addend[..., None]
    watermarked = torch.clamp(output + addend, 0.0, 255.0)
    return (_gate(watermarked, valid, output),
            torch.where(valid, strength, 0.0))


def _embed_shard_cuda(imgs: Shards, outputs: Shards, wms: Shards,
                      strength_factor_value: float, mask_type: str, p: int):
    """Per shard: the Gram (ME) and the embed field in their halo forms,
    the frame extended by max(1, p // 2) rows (the field's reach, and the
    3x3 Gram's); sum u^2 psum'd and max |e| pmax'd."""
    _require_kernel_route(len(imgs), mask_type, p, "cuda")
    h_local, cols = imgs[0].shape[-2:]
    batch_shape = imgs[0].shape[:-2]
    half = max(1, p // 2)
    ext = [_flat(e) for e in exchange_row_halo(imgs, half)]
    if mask_type == "me":
        solved = _solve_cuda(imgs, ext, half, p)
    else:
        solved = [(None, torch.ones(e.shape[0], dtype=torch.bool,
                                    device=e.device)) for e in ext]
    fields = [embed_field(e, w.contiguous(), c, mask_type, p, half, half)
              for e, w, (c, _) in zip(ext, wms, solved)]
    sum_u2 = psum([f[1] for f in fields])
    max_e = pmax([f[2] for f in fields])
    total = len(imgs) * h_local * cols
    results = []
    for (u_raw, _, _), (_, valid), s, m, out in zip(fields, solved, sum_u2,
                                                     max_e, outputs):
        scale = strength_factor_value * math.sqrt(total) / torch.sqrt(s)
        strength = scale * m if mask_type == "me" else scale
        results.append(_finish_embed(
            u_raw.reshape(batch_shape + (h_local, cols)),
            scale.reshape(batch_shape), strength.reshape(batch_shape),
            valid.reshape(batch_shape), out))
    return results


def _embed_shard(imgs: Shards, outputs: Shards, wms: Shards,
                 strength_factor_value: float, mask_type: str, p: int,
                 impl: str = "cuda"):
    """Embed into row-sharded outputs: [(watermarked, strength)] per
    shard, strengths (...,) the same on every shard."""
    imgs = [_to_f32(x) for x in imgs]
    outputs = [_to_f32(o) for o in outputs]
    wms = [_to_f32(w) for w in wms]
    if impl == "cuda":
        return _embed_shard_cuda(imgs, outputs, wms, strength_factor_value,
                                 mask_type, p)
    if mask_type == "me":
        solved = _analysis_local(imgs, p)
        valid = [v for _, v in solved]
        errors = _error_local(imgs, [c for c, _ in solved], p)
        top = pmax([e.abs().amax(dim=(-2, -1), keepdim=True)
                    for e in errors])
        mask = [e.abs() / m for e, m in zip(errors, top)]
    else:
        mask = _nvf_local(imgs, p)
        valid = [torch.ones(x.shape[:-2], dtype=torch.bool, device=x.device)
                 for x in imgs]
    u = [m * w for m, w in zip(mask, wms)]
    norm_sq = psum([(x * x).sum(dim=(-2, -1)) for x in u])
    total = len(imgs) * imgs[0].shape[-2] * imgs[0].shape[-1]
    results = []
    for x, n, v, out in zip(u, norm_sq, valid, outputs):
        strength = strength_factor_value / torch.sqrt(n / total)
        results.append(_finish_embed(x, strength, strength, v, out))
    return results


def shard_rows(mesh: Mesh, image) -> Sharded:
    """Place an (H, W[, C]) image with rows split over the space axis (and
    copies on every data row)."""
    return shard(mesh, image, (SPACE_AXIS,))


def make_spatial_detect(mesh: Mesh, mask_type: str, p: int = 3,
                        impl: str = "cuda"):
    """Row-sharded detect: (H, W) image, (H, W) watermark -> the
    correlation, a ``Sharded`` scalar (``float(...)`` reads it).

    ``impl="cuda"`` runs the Gram and detect-tail kernels' halo forms per
    shard; ME at p > 3 over more than one space shard raises
    ``NotImplementedError`` there (use ``impl="torch"``)."""
    _check_args(mask_type, p, impl)
    _require_kernel_route(mesh.shape[SPACE_AXIS], mask_type, p, impl)

    def detect(image, watermark) -> Sharded:
        image = shard_rows(mesh, image)
        watermark = shard_rows(mesh, watermark)
        return Sharded(mesh, (), [
            _detect_shard(image.row(i), watermark.row(i), mask_type, p,
                          impl) for i in range(mesh.shape[DATA_AXIS])])
    return detect


def make_spatial_embed(mesh: Mesh, mask_type: str,
                       strength_factor_value: float, p: int = 3,
                       channels: bool = False, impl: str = "cuda"):
    """Row-sharded embed: (H, W) image, (H, W[, C]) output, (H, W)
    watermark -> (watermarked, row-sharded like the output; strength, a
    ``Sharded`` scalar). ``channels`` does nothing: it mirrors the JAX
    package's signature, and the output's shape carries it (the JAX
    package's ``rows`` and ``cols`` are not taken). ``impl`` as in
    ``make_spatial_detect``."""
    del channels
    _check_args(mask_type, p, impl)
    _require_kernel_route(mesh.shape[SPACE_AXIS], mask_type, p, impl)

    def embed(image, output, watermark) -> tuple[Sharded, Sharded]:
        image, output = shard_rows(mesh, image), shard_rows(mesh, output)
        watermark = shard_rows(mesh, watermark)
        per_row = [_embed_shard(image.row(i), output.row(i),
                                watermark.row(i), strength_factor_value,
                                mask_type, p, impl)
                   for i in range(mesh.shape[DATA_AXIS])]
        return (Sharded(mesh, output.spec,
                        [[w for w, _ in row] for row in per_row]),
                Sharded(mesh, (), [[s for _, s in row] for row in per_row]))
    return embed
