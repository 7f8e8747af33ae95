"""Prediction-error (ME) mask: normal equations, solve, prediction, mask.

Reference behavior:

* Over every pixel, accumulate the 8-neighbor outer products
  ``Rx = sum_p n(p) n(p)^T`` and the neighbor-center correlations
  ``rx = sum_p n(p) * center(p)`` (``kernels/me_p3.hpp:8-21,59-82``), then
  solve ``Rx a = rx`` (``Watermark.cpp:140-151,200-207``).
* Prediction ``x_hat = sum_k a_k * neighbor_k``; error ``e = image - x_hat``;
  mask ``|e| / max|e|`` (``Watermark.cpp:210-215``).
* An unsolvable system makes the reference skip embedding and report
  correlation 0 (``Watermark.cpp:202-207``). Here singularity surfaces as a
  per-image ``valid`` flag that callers apply with ``torch.where`` — no host
  sync, no exception.

The reference hard-codes p=3 (8 taps); like the JAX package, every function
here takes ``p`` in {3, 5, 7, 9} and generalizes to the (p*p-1)-tap
predictor. All functions are batch-polymorphic over leading dims: images
(..., H, W), coefficients (..., k), Rx (..., k, k), rx (..., k) with
k = p*p - 1.

The Gram, the prediction error and the lag functions also take a halo
form for row shards (``parallel/spatial.py``): ``image`` is then (..., top
+ H + bottom, W), H owned rows with ``top`` rows above and ``bottom``
below (true neighbour rows at a seam, replicated edge rows at the frame's
border), rows read clamped to that range (``neighbors.pad_halo``) and the
sums and errors over the owned rows only. ``top = bottom = 0`` is the
frame itself.
"""

from __future__ import annotations

import functools

import torch

from .neighbors import neighbor_offsets, pad_edge, pad_halo, shifted_views

SUPPORTED_P = (3, 5, 7, 9)


def require_supported_p(p: int) -> None:
    """Raise for a window size the system does not have."""
    if p not in SUPPORTED_P:
        raise ValueError(f"p must be one of {SUPPORTED_P}, got {p}")


def wide_lag_geometry(rows: int, cols: int, p: int) -> bool:
    """Does a (rows, cols) frame take the lag form of the wide Gram?

    The JAX package's rule (``ops/me.py::gram_terms_from_padded``,
    ``me_gram_wide.py::wide_gram_supported``): p > 3 and at least 6h rows
    and columns (h = p // 2), so that the boundary-row banks of the lag
    assembly lie inside the clamp-extended frame. Smaller frames take the
    direct per-pair sums.
    """
    half = p // 2
    return p != 3 and rows >= 6 * half and cols >= 6 * half


def gram_direct(image: torch.Tensor, p: int = 3, top: int = 0,
                bottom: int = 0) -> torch.Tensor:
    """(..., H, W) -> (..., k+1, k+1) Gram of [k clamped neighbors; center]
    by direct per-pair sums of elementwise products (full f32; no matmul, so
    no TF32 question arises on the card); the halo form sums the owned
    rows of a (..., top + H + bottom, W) shard."""
    require_supported_p(p)
    cols = image.shape[-1]
    rows = image.shape[-2] - top - bottom
    views = shifted_views(pad_halo(image, p // 2, top, bottom), rows, cols,
                          p)
    views.append(image[..., top:top + rows, :])
    n = len(views)
    gram = image.new_empty(*image.shape[:-2], n, n)
    for i in range(n):
        for j in range(i, n):
            total = (views[i] * views[j]).sum(dim=(-2, -1))
            gram[..., i, j] = total
            gram[..., j, i] = total
    return gram


# ---- the lag form of the wide Gram (p > 3) --------------------------------
#
# The JAX package's ops/pallas/me_gram_wide.py and ops/me.py::lag_partials:
# every pair sum of the Gram is a window sum of one lag product plane
# Q_d[y, x] = P[y, x] * P[y + dr, x + dc] of the clamp-extended image P.
# Oriented canonically (dr > 0, or dr == 0 and dc >= 0) there are
# ((4h+1)^2 + 1) / 2 lags, h = p // 2: 41, 85 and 145. The per-lag lane
# partials V_d[v] = sum_{y in [0, H)} P[y, v - h] * P[y + dr, v - h + dc],
# lanes v in [0, W + 2h) (image columns [-h, W + h)), are the JAX package's
# kernel contract (``lag_partials_plain``); ``assemble_wide`` turns them
# into the Gram with a few vectorized ops: each pair's column window is the
# full lane sum less <= 2h edge lanes, and the pairs whose window is
# row-shifted take boundary-row corrections from the low and high row banks
# of the clamp-extended image. The two make ``me_gram_wide_plain``, the
# torch route and the card's oracle. The port's kernels need only the full
# lane sums and the edge lanes (``lag_strips_plain`` and
# ``assemble_strips_plain`` below). All of it needs rows, cols >= 6h
# (``wide_lag_geometry``).


@functools.cache
def lag_plan(p: int):
    """Static per-p assembly plan (the JAX package's ``_plan``, with the
    center-center pair kept so the Gram is complete).

    Returns (lags, pair_lag, pair_ar, pair_ai, pair_index):
    lags       -- canonical (dr, dc) lags, dr >= 0 (dc >= 0 when dr == 0)
    pair_lag   -- per pair, index into lags
    pair_ar    -- per pair, window row offset in [-h, h]
    pair_ai    -- per pair, window column index ac + h in [0, 2h]
    pair_index -- (k+1) x (k+1) nested list of pair ids
    """
    h = p // 2
    offsets = list(neighbor_offsets(p)) + [(0, 0)]   # center last
    n = len(offsets)
    lags: list[tuple[int, int]] = []
    pair_lag, pair_ar, pair_ai, pairs = [], [], [], []
    for a in range(n):
        for b in range(a, n):
            first, second = offsets[a], offsets[b]
            lag = (second[0] - first[0], second[1] - first[1])
            if lag < (0, 0):    # reorient: Q_{-d} is a shifted Q_d
                lag = (-lag[0], -lag[1])
                first = second
            if lag not in lags:
                lags.append(lag)
            pairs.append((a, b))
            pair_lag.append(lags.index(lag))
            pair_ar.append(first[0])
            pair_ai.append(first[1] + h)
    pair_index = [[0] * n for _ in range(n)]
    for i, (a, b) in enumerate(pairs):
        pair_index[a][b] = pair_index[b][a] = i
    assert len(lags) == ((4 * h + 1) ** 2 + 1) // 2
    return tuple(lags), pair_lag, pair_ar, pair_ai, pair_index


@functools.lru_cache(maxsize=16)
def _indices(p: int, cols: int, device: torch.device) -> dict:
    """Index tensors of the assembly for W = ``cols``, on ``device``."""
    h = p // 2
    lags, pair_lag, pair_ar, pair_ai, pair_index = lag_plan(p)
    na = 2 * h + 1
    lag_t = torch.tensor(lags, dtype=torch.long)
    pair_lag_t = torch.tensor(pair_lag, dtype=torch.long)
    ar = torch.tensor(pair_ar, dtype=torch.long)
    ai = torch.tensor(pair_ai, dtype=torch.long)
    per_lag = (2 * h + 1) * na
    index = {
        "base": pair_lag_t * na + ai,
        "hi": pair_lag_t * per_lag + (h + ar.clamp(min=0)) * na + ai,
        "lo": pair_lag_t * per_lag + (h + ar.clamp(max=0)) * na + ai,
        "sign": ar.sign().to(torch.float32),
        "pair": torch.tensor(pair_index, dtype=torch.long),
        # Q_d's bottom factor in a bank: rows dr + [0, 2h), lanes
        # 2h + dc + [0, W + 2h)
        "q_rows": lag_t[:, 0, None] + torch.arange(2 * h),
        "q_cols": 2 * h + lag_t[:, 1, None] + torch.arange(cols + 2 * h),
    }
    return {name: t.to(device) for name, t in index.items()}


def lag_partials_plain(image: torch.Tensor, p: int, top: int = 0,
                       bottom: int = 0) -> torch.Tensor:
    """(B, H, W) -> (B, L, W + 2h) per-lag lane partials (the JAX package's
    wide Gram kernel contract, its ``ops.me.lag_partials`` over a 3h-padded
    image); the halo form sums the owned rows of a (B, top + H + bottom, W)
    shard, whose lag products read its rows below them."""
    h = p // 2
    cols = image.shape[-1]
    rows = image.shape[-2] - top - bottom
    # image row 0 at 3h + top, column -h at 2h
    ext = pad_edge(image, 3 * h)
    y0 = 3 * h + top
    base = ext[:, y0:y0 + rows, 2 * h:4 * h + cols]
    return torch.stack(
        [(base * ext[:, y0 + dr:y0 + dr + rows,
                     2 * h + dc:4 * h + dc + cols]).sum(dim=-2)
         for dr, dc in lag_plan(p)[0]], dim=1)


def _lane_windows(full: torch.Tensor, edges: torch.Tensor,
                  h: int) -> torch.Tensor:
    """All 2h+1 lane windows [ai, ai + W) of lanes [0, W + 2h) from their
    full sum (...) and their 2h left and 2h right edge lanes (..., 4h): the
    full sum less the ai left and 2h - ai right edge lanes."""
    zero = full.new_zeros(full.shape + (1,))
    left = torch.cat([zero, edges[..., :2 * h].cumsum(dim=-1)], dim=-1)
    right = torch.cat([zero, edges[..., 2 * h:].flip(-1).cumsum(dim=-1)],
                      dim=-1)
    return full[..., None] - left - right.flip(-1)


def edge_windows(x: torch.Tensor, h: int) -> torch.Tensor:
    """All 2h+1 lane windows of (..., W + 2h) partials."""
    return _lane_windows(x.sum(dim=-1),
                         torch.cat([x[..., :2 * h], x[..., -2 * h:]], dim=-1),
                         h)


def assemble_wide(partials: torch.Tensor, image: torch.Tensor,
                  p: int) -> torch.Tensor:
    """(B, L, W + 2h) lane partials of the (B, H, W) image
    -> (B, k+1, k+1) Gram (the JAX package's ``_assemble_wide`` with the
    boundary rows taken from the raw image at clamped indices)."""
    return _assemble(edge_windows(partials, p // 2), image, p)


def _assemble(windows: torch.Tensor, image: torch.Tensor, p: int,
              top: int = 0, bottom: int = 0) -> torch.Tensor:
    """(B, L, 2h+1) column windows of each lag's sum over rows [0, H)
    -> (B, k+1, k+1) Gram, with the boundary-row corrections from the
    banks of the (B, top + H + bottom, W) image."""
    h = p // 2
    rows = image.shape[1] - top - bottom
    cols = image.shape[2]
    bank = torch.arange(-h, 3 * h, device=image.device)
    bank_cols = torch.arange(-3 * h, cols + 3 * h,
                             device=image.device).clamp(0, cols - 1)

    def rows_of(first):
        # rows first + [-h, 3h), clamped to the image's, columns
        # [-3h, W + 3h) clamped
        index = (first + bank).clamp(-top, rows + bottom - 1) + top
        return image.index_select(1, index).index_select(2, bank_cols)
    return assemble_banks(windows, rows_of(0), rows_of(rows), p)


def assemble_banks(windows: torch.Tensor, low: torch.Tensor,
                   high: torch.Tensor, p: int) -> torch.Tensor:
    """(B, L, 2h+1) column windows of each lag's sum over rows [0, H)
    -> (B, k+1, k+1) Gram, the boundary-row corrections taken from the
    (B, 4h, W + 6h) banks of the clamp-extended frame: rows [-h, 3h)
    (``low``) and [H - h, H + 3h) (``high``), columns [-3h, W + 3h). A
    row-sharded frame's banks lie on its edge shards (``parallel``)."""
    h = p // 2
    batch = windows.shape[0]
    cols = low.shape[-1] - 6 * h
    index = _indices(p, cols, low.device)

    # base windows: rows [0, H) of each lag, all 2h+1 column windows
    base = windows.reshape(batch, -1)[:, index["base"]]

    def q_windows(bank):
        # Q_d over bank rows [-h, h): row j times row j + dr shifted dc
        # lanes, then all column windows; cumulated over the block rows with
        # a zero first, so cum[:, :, m] sums block rows [0, m)
        top = bank[:, None, 0:2 * h, 2 * h:4 * h + cols]
        bottom = bank[:, index["q_rows"][:, :, None],
                      index["q_cols"][:, None, :]]
        windows = edge_windows(top * bottom, h)       # (B, L, 2h, 2h+1)
        return torch.cat([torch.zeros_like(windows[:, :, :1]),
                          windows.cumsum(dim=2)], dim=2)

    # a pair's window rows [ar, H + ar) correct the base rows [0, H) by
    # sign(ar) * (D[h + max(ar, 0)] - D[h + min(ar, 0)]), D = cumHigh - cumLow
    diff = (q_windows(high) - q_windows(low)).reshape(batch, -1)
    values = base + index["sign"] * (diff[:, index["hi"]]
                                     - diff[:, index["lo"]])
    return values[:, index["pair"]]


def me_gram_wide_plain(image: torch.Tensor, p: int) -> torch.Tensor:
    """(B, H, W) -> (B, k+1, k+1) Gram of the lag form in plain torch
    (rows, cols >= 6h)."""
    return assemble_wide(lag_partials_plain(image, p), image, p)


# ---- the wide Gram kernels' own functions ---------------------------------
#
# The lag kernel (csrc/me_gram_wide.cu) splits the rows into strips and the
# lanes into blocks as ``wide_lag_layout`` says (the last strip and block
# shorter); per (image, lag, strip, lane block) it writes the sum over the
# block's lanes, and per (image, lag, strip) the 2h left and 2h right edge
# lanes. The assembly kernel turns that and the frame's two boundary banks
# (``frame_banks``) into the Gram. Below are their plain versions; chained,
# they are the CPU route of ``ops.cuda.me_gram_wide``. The lag kernel's
# output is a sum over rows, so a row shard's (its halo form) adds up to
# the frame's.

# lanes a block of the lag kernel: its threads a block (the kernel refuses
# any other value)
LANE_BLOCK = 128
# rows a strip of the lag kernel, per p: the fastest of a sweep on an H100
# (tools/ab_wide_gram.py)
WIDE_STRIP_ROWS = {5: 120, 7: 180, 9: 270}


def wide_lag_layout(rows: int, cols: int, p: int) -> tuple[int, int, int]:
    """(strip rows, strips, lane blocks) of the lag kernel's output for a
    (rows, cols) frame at window p."""
    strip = min(rows, WIDE_STRIP_ROWS[p])
    return strip, -(-rows // strip), -(-(cols + 2 * (p // 2)) // LANE_BLOCK)


def lag_strips_plain(image: torch.Tensor, p: int, top: int = 0,
                     bottom: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, H, W) -> (sums (B, L, S, NB), edges (B, L, S, 4h)): per strip of
    rows (``wide_lag_layout``) the lane partials' sum over each block of
    LANE_BLOCK lanes and their 2h left and 2h right edge lanes, lags in
    ``lag_plan`` order (the plain version of the lag kernel); the halo form
    sums the owned rows of a (B, top + H + bottom, W) shard, whose lag
    products read its rows below them."""
    h = p // 2
    batch, rows, cols = image.shape
    rows -= top + bottom
    strip, n_strips, n_blocks = wide_lag_layout(rows, cols, p)
    lanes = cols + 2 * h
    ext = pad_edge(image, 3 * h)   # image row 0 at 3h, column -h at 2h
    y0 = 3 * h + top
    base = ext[:, y0:y0 + rows, 2 * h:4 * h + cols]
    sums, edges = [], []
    for dr, dc in lag_plan(p)[0]:
        product = base * ext[:, y0 + dr:y0 + dr + rows,
                             2 * h + dc:4 * h + dc + cols]
        product = torch.nn.functional.pad(
            product, (0, n_blocks * LANE_BLOCK - lanes, 0,
                      n_strips * strip - rows))
        per_strip = product.reshape(batch, n_strips, strip, -1).sum(dim=2)
        sums.append(per_strip.reshape(batch, n_strips, n_blocks,
                                      LANE_BLOCK).sum(dim=-1))
        edges.append(torch.cat([per_strip[..., :2 * h],
                                per_strip[..., cols:cols + 2 * h]], dim=-1))
    return torch.stack(sums, dim=1), torch.stack(edges, dim=1)


@functools.lru_cache(maxsize=16)
def _bank_rows(rows: int, h: int, device: torch.device) -> torch.Tensor:
    """The frame rows of the two boundary banks, [-h, 3h) and
    [H - h, H + 3h), clamped to [0, H), on ``device``."""
    bank = torch.arange(-h, 3 * h)
    return torch.cat([bank, rows + bank]).clamp(0, rows - 1).to(device)


def frame_banks(image: torch.Tensor, p: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The (B, H, W) frames' boundary banks, (B, 4h, W) each at raw
    columns: rows [-h, 3h) (``low``) and [H - h, H + 3h) (``high``),
    clamped to the frame; two views of one (B, 8h, W) gather."""
    h = p // 2
    both = image.index_select(-2, _bank_rows(image.shape[-2], h,
                                             image.device))
    return both[..., :4 * h, :], both[..., 4 * h:, :]


def assemble_strips_plain(sums: torch.Tensor, edges: torch.Tensor,
                          low: torch.Tensor, high: torch.Tensor,
                          p: int) -> torch.Tensor:
    """The lag kernel's (sums, edges) over a frame's rows (any strips and
    lane blocks: a row shard's, folded) and the frame's (B, 4h, W) banks
    (``frame_banks``) -> (B, k+1, k+1) Gram (the plain version of the
    assembly kernel)."""
    h = p // 2
    cols = low.shape[-1]
    bank_cols = torch.arange(-3 * h, cols + 3 * h,
                             device=low.device).clamp(0, cols - 1)
    return assemble_banks(
        _lane_windows(sums.sum(dim=(2, 3)), edges.sum(dim=2), h),
        low.index_select(-1, bank_cols), high.index_select(-1, bank_cols), p)


# ---- the 3x3 Gram kernels' own functions ----------------------------------
#
# The lag kernel of the 3x3 Gram (csrc/me_gram.cu) sums each of the 13 lag
# products Q_d over the frame's own columns [0, W) only, per strip of rows
# and block of columns (``gram_lag_layout``); the assembly kernel takes the
# column windows [-1, W - 1) and [1, W + 1) as that interior plus the
# difference of two columns of Q_d, then the boundary-row corrections. No
# geometry rule: every frame of at least one pixel takes this form.

# columns a block of the 3x3 lag kernel: its 128 threads, 4 columns each
# (the kernel refuses any other value)
GRAM_BLOCK_COLS = 512
# rows a strip of the 3x3 lag kernel: the fastest of a sweep on an H100
# (tools/ab_me_gram.py)
GRAM_STRIP_ROWS = 24


def gram_lag_layout(rows: int, cols: int) -> tuple[int, int, int]:
    """(strip rows, strips, column blocks) of the 3x3 lag kernel's output
    for a (rows, cols) frame."""
    strip = min(rows, GRAM_STRIP_ROWS)
    return strip, -(-rows // strip), -(-cols // GRAM_BLOCK_COLS)


def _lag_products(ext: torch.Tensor, rows: slice, cols: slice,
                  dr: int, dc: int) -> torch.Tensor:
    """Q_d = P[y, x] * P[y + dr, x + dc] over rows ``rows`` and columns
    ``cols`` of ``ext``, the frames edge-padded by 3 (image row 0 at 3)."""
    shift = ext[:, rows.start + dr:rows.stop + dr, cols.start + dc:
                cols.stop + dc]
    return ext[:, rows, cols] * shift


def gram_lags_plain(image: torch.Tensor, top: int = 0,
                    bottom: int = 0) -> torch.Tensor:
    """(B, H, W) -> (B, 13, S, NB): per strip of rows and block of columns
    (``gram_lag_layout``) the sum of each lag product Q_d over the frame's
    own columns, lags in ``lag_plan(3)`` order (the plain version of the
    3x3 lag kernel); the halo form sums the owned rows of a (B, top + H +
    bottom, W) shard."""
    batch, rows, cols = image.shape
    rows -= top + bottom
    strip, n_strips, n_blocks = gram_lag_layout(rows, cols)
    ext = pad_edge(image, 3)
    y0 = 3 + top
    sums = []
    for dr, dc in lag_plan(3)[0]:
        product = _lag_products(ext, slice(y0, y0 + rows),
                                slice(3, 3 + cols), dr, dc)
        product = torch.nn.functional.pad(
            product, (0, n_blocks * GRAM_BLOCK_COLS - cols, 0,
                      n_strips * strip - rows))
        sums.append(product.reshape(batch, n_strips, strip, n_blocks,
                                    GRAM_BLOCK_COLS).sum(dim=(2, 4)))
    return torch.stack(sums, dim=1)


def assemble_lags_plain(sums: torch.Tensor, image: torch.Tensor,
                        top: int = 0, bottom: int = 0) -> torch.Tensor:
    """The 3x3 lag kernel's (B, 13, S, NB) sums of the (B, H, W) image
    -> (B, 9, 9) Gram (the plain version of the 3x3 assembly kernel): the
    column windows [ac, W + ac) of each lag's sum over rows [0, H) are the
    interior plus C(-1) - C(W - 1) (ac = -1) or C(W) - C(0) (ac = 1), C(x)
    column x of Q_d over rows [0, H); ``_assemble`` adds the boundary-row
    corrections. The halo form takes a (B, top + H + bottom, W) shard."""
    rows, cols = image.shape[-2:]
    rows -= top + bottom
    interior = sums.sum(dim=(2, 3))
    ext = pad_edge(image, 3)
    y0 = 3 + top
    column = {}
    for x in (-1, 0, cols - 1, cols):
        column[x] = torch.stack(
            [_lag_products(ext, slice(y0, y0 + rows), slice(3 + x, 4 + x),
                           dr, dc).sum(dim=(1, 2))
             for dr, dc in lag_plan(3)[0]], dim=1)
    windows = torch.stack([interior + (column[-1] - column[cols - 1]),
                           interior,
                           interior + (column[cols] - column[0])], dim=-1)
    return _assemble(windows, image, 3, top, bottom)



def me_normal_equations(image: torch.Tensor, p: int = 3
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Accumulate Rx (..., k, k) and rx (..., k) over all pixels.

    p > 3 at ``wide_lag_geometry`` takes the lag form of the JAX package's
    ``_gram_lags_vectorized`` (``lag_partials_plain`` plus
    ``assemble_wide``); everything else the direct per-pair sums.
    """
    require_supported_p(p)
    k = p * p - 1
    if wide_lag_geometry(*image.shape[-2:], p):
        lead = image.shape[:-2]
        gram = me_gram_wide_plain(image.reshape(-1, *image.shape[-2:]), p)
        gram = gram.reshape(*lead, k + 1, k + 1)
    else:
        gram = gram_direct(image, p)
    return gram[..., :k, :k], gram[..., :k, k]


def _gate_finite(coefficients: torch.Tensor, valid: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fold non-finite solutions into ``valid`` and zero invalid rows, so
    downstream math stays finite."""
    valid = valid & torch.isfinite(coefficients).all(dim=-1)
    return (torch.where(valid[..., None], coefficients,
                        torch.zeros_like(coefficients)), valid)


def solve_coefficients(rx_matrix: torch.Tensor, rx_vector: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Solve Rx a = rx (batched LU). Returns (coefficients, valid).

    ``torch.linalg.solve`` raises on a singular matrix, so the factorization
    reports instead: ``valid`` is False where ``info`` flags a zero pivot,
    where the solution is not finite, or where the smallest pivot is below
    ``k * eps`` of the largest. The last catches systems that are singular
    in exact arithmetic but whose blocked f32 elimination leaves a rounding
    residue for a pivot (a constant frame's rank-1 Gram does that in MKL),
    where the "solution" means nothing.
    """
    lu, pivots, info = torch.linalg.lu_factor_ex(rx_matrix)
    solution = torch.linalg.lu_solve(lu, pivots, rx_vector[..., None])
    diag = lu.diagonal(dim1=-2, dim2=-1).abs()
    floor = rx_matrix.shape[-1] * torch.finfo(rx_matrix.dtype).eps
    well_posed = diag.amin(dim=-1) > floor * diag.amax(dim=-1)
    return _gate_finite(solution[..., 0], (info == 0) & well_posed)


def _chol8_factor(rx_matrix: torch.Tensor) -> list[list]:
    """Lower Cholesky factor of the SPD blocks (..., n, n) by the unrolled
    scalar recurrence, as an n x n list of (...,) tensors (None above the
    diagonal): each sum starts at 0 and adds the products in increasing k,
    then the pivot's reciprocal is taken once and multiplied. A zero or
    negative pivot gives Inf/NaN."""
    n = rx_matrix.shape[-1]
    a = [[rx_matrix[..., i, j] for j in range(n)] for i in range(n)]
    lower: list[list] = [[None] * n for _ in range(n)]
    for j in range(n):
        diag = a[j][j] - sum((lower[j][k] * lower[j][k] for k in range(j)),
                             start=torch.zeros_like(a[j][j]))
        lower[j][j] = torch.sqrt(diag)
        inv_diag = 1.0 / lower[j][j]
        for i in range(j + 1, n):
            off = a[i][j] - sum((lower[i][k] * lower[j][k] for k in range(j)),
                                start=torch.zeros_like(a[i][j]))
            lower[i][j] = off * inv_diag
    return lower


def solve_coefficients_spd(rx_matrix: torch.Tensor, rx_vector: torch.Tensor
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Unrolled batched Cholesky solve for the SPD Gram system.

    The same scalar recurrence as the JAX package's solver, in (B,)-vector
    arithmetic. A zero or negative pivot gives Inf/NaN, which becomes
    ``valid=False`` (the reference's solve-failure contract).
    """
    n = rx_matrix.shape[-1]
    lower = _chol8_factor(rx_matrix)
    # forward substitution L y = rx
    y = []
    for i in range(n):
        y.append((rx_vector[..., i]
                  - sum((lower[i][k] * y[k] for k in range(i)),
                        start=torch.zeros_like(rx_vector[..., i])))
                 / lower[i][i])
    # back substitution L^T x = y
    x: list = [None] * n
    for i in reversed(range(n)):
        x[i] = (y[i] - sum((lower[k][i] * x[k] for k in range(i + 1, n)),
                           start=torch.zeros_like(y[i]))) / lower[i][i]
    coefficients = torch.stack(x, dim=-1)
    return _gate_finite(coefficients, torch.ones_like(coefficients[..., 0],
                                                      dtype=torch.bool))


# the blocked solve's panel width: the 8x8 diagonal factor of
# ``_chol8_factor``, which the kernel (``csrc/spd_solve.cu``) hard-codes too
SOLVE_BLOCK = 8


def _trisolve_block_right(s: torch.Tensor, l11: torch.Tensor
                          ) -> torch.Tensor:
    """Solve X @ L11^T = S for X, batched: (..., r, 8) x (..., 8, 8) lower,
    column by column, each column's products subtracted in turn, then
    divided by the pivot."""
    cols: list = []
    for c in range(l11.shape[-1]):
        acc = s[..., c]
        for k2 in range(c):
            acc = acc - cols[k2] * l11[..., c, k2, None]
        cols.append(acc / l11[..., c, c, None])
    return torch.stack(cols, dim=-1)


def solve_coefficients_spd_blocked(rx_matrix: torch.Tensor,
                                   rx_vector: torch.Tensor
                                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Blocked batched Cholesky solve for the wide (k = 24/48/80) systems:
    the JAX package's ``solve_coefficients_spd_blocked``, step for step.

    Column panels of ``SOLVE_BLOCK`` columns, left to right: each panel's rows at
    and below its diagonal take the earlier panels' products subtracted one
    panel at a time (f32 matmuls; on the card TF32 must be off), its 8x8
    diagonal block is factored by ``_chol8_factor`` and the rows below by
    ``_trisolve_block_right``. Then forward and back substitution block by
    block: the solved prefix's product subtracted a block at a time, then 8
    scalar steps. ``valid`` is "all coefficients finite" (a zero or
    negative pivot gives Inf/NaN) and invalid rows are zeros. The plain
    version of ``ops/cuda/solve.py::spd_solve_wide``.
    """
    n = rx_matrix.shape[-1]
    block = SOLVE_BLOCK
    if n % block:
        raise ValueError(f"the blocked solve takes a multiple of {block} "
                         f"unknowns, got {n}")
    lead = rx_matrix.shape[:-2]
    blocks = n // block
    panels: list[torch.Tensor] = []    # (..., n, block) column panels of L
    for b in range(blocks):
        j0 = b * block
        s = rx_matrix[..., j0:, j0:j0 + block]
        for prev in panels:
            s = s - prev[..., j0:, :] @ prev[..., j0:j0 + block, :].mT
        lower = _chol8_factor(s[..., :block, :])
        zero = torch.zeros_like(lower[0][0])
        l11 = torch.stack([torch.stack([lower[i][j] if j <= i else zero
                                        for j in range(block)], dim=-1)
                           for i in range(block)], dim=-2)
        parts = [rx_matrix.new_zeros(*lead, j0, block), l11]
        if j0 + block < n:
            parts.append(_trisolve_block_right(s[..., block:, :], l11))
        panels.append(torch.cat(parts, dim=-2))

    # forward substitution L y = rx, block by block
    y: list[torch.Tensor] = []
    for b in range(blocks):
        j0 = b * block
        rhs = rx_vector[..., j0:j0 + block]
        for pb in range(b):
            rhs = rhs - (panels[pb][..., j0:j0 + block, :]
                         @ y[pb][..., None])[..., 0]
        l11 = panels[b][..., j0:j0 + block, :]
        yb: list = []
        for i in range(block):
            acc = rhs[..., i]
            for k2 in range(i):
                acc = acc - l11[..., i, k2] * yb[k2]
            yb.append(acc / l11[..., i, i])
        y.append(torch.stack(yb, dim=-1))

    # back substitution L^T x = y, block by block from the last
    x: list = [None] * blocks
    for b in reversed(range(blocks)):
        j0 = b * block
        rhs = y[b]
        for pb in range(b + 1, blocks):
            pj = pb * block
            rhs = rhs - (panels[b][..., pj:pj + block, :].mT
                         @ x[pb][..., None])[..., 0]
        l11 = panels[b][..., j0:j0 + block, :]
        xb: list = [None] * block
        for i in reversed(range(block)):
            acc = rhs[..., i]
            for k2 in range(i + 1, block):
                acc = acc - l11[..., k2, i] * xb[k2]
            xb[i] = acc / l11[..., i, i]
        x[b] = torch.stack(xb, dim=-1)
    coefficients = torch.cat(x, dim=-1)
    return _gate_finite(coefficients, torch.ones_like(coefficients[..., 0],
                                                      dtype=torch.bool))


def solve_coefficients_spd_wide(rx_matrix: torch.Tensor,
                                rx_vector: torch.Tensor
                                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched Cholesky solve for the wide (k = 24/48/80) Gram systems.

    ``torch.linalg.cholesky_ex`` reports a non-positive pivot in ``info``
    instead of raising; ``valid`` is ``info == 0`` and a finite solution,
    and invalid rows are zeroed. The plain route's (``impl="torch"``)
    solve, where the JAX package's ``impl="xla"`` takes
    ``solve_coefficients_spd_vec`` (the same factorisation, another order);
    the kernel route runs the JAX package's blocked Cholesky
    (``solve_coefficients_spd_blocked``) through the hand-written kernel
    ``ops/cuda/solve.py::spd_solve_wide``.
    """
    lower, info = torch.linalg.cholesky_ex(rx_matrix)
    solution = torch.cholesky_solve(rx_vector[..., None], lower)[..., 0]
    return _gate_finite(solution, info == 0)


def prediction_error(image: torch.Tensor, coefficients: torch.Tensor,
                     p: int = 3, top: int = 0,
                     bottom: int = 0) -> torch.Tensor:
    """Error sequence e = image - sum_k c_k * neighbor_k (clamped), with the
    taps subtracted in coefficient order (the order the kernels use); the
    halo form gives the owned rows of a (..., top + H + bottom, W)
    shard."""
    require_supported_p(p)
    cols = image.shape[-1]
    rows = image.shape[-2] - top - bottom
    error = image[..., top:top + rows, :]
    for k, view in enumerate(shifted_views(pad_halo(image, p // 2, top,
                                                    bottom), rows, cols, p)):
        error = error - coefficients[..., k, None, None] * view
    return error


def predict(image: torch.Tensor, coefficients: torch.Tensor,
            p: int = 3) -> torch.Tensor:
    """(p*p-1)-tap linear prediction of each pixel from its clamped
    neighbors."""
    return image - prediction_error(image, coefficients, p)


def me_mask_from_error(error: torch.Tensor) -> torch.Tensor:
    """Normalized |error| mask: |e| / max|e| per image."""
    abs_error = error.abs()
    return abs_error / abs_error.amax(dim=(-2, -1), keepdim=True)
