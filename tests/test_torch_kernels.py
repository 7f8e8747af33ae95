"""Each kernel module of the port: the plain PyTorch version against the JAX
package's Pallas kernel (interpret mode on the CPU, as tests/test_pallas.py
runs it), with the same inputs and coefficients fed to both. The CUDA
kernels themselves are held to these plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py.

The 3x3 Gram's two kernels (the lag sums over row strips and column
blocks, and their assembly) have plain versions of their own: chained, they
are held to the JAX package's Pallas Gram and to the direct per-pair sums
at ragged shapes, and their strip sums to the lag products they add up.

Tolerances: Gram rtol 1e-4; u_raw rtol 1e-5 + atol 1e-3 (the per-pixel
terms round alike, only the image-wide max and sum are reductions);
reductions rtol 1e-4; correlations abs 2e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from watermarking_gpu_tpu.ops.pallas.common import RAW_PAD, raw_mode_ok
from watermarking_gpu_tpu.ops.pallas.fused import (fused_detect_tail,
                                                   fused_embed_field,
                                                   pipeline_geometry)
from watermarking_gpu_tpu.ops.pallas.me_kernel import (
    me_gram_pallas, me_gram_raw, me_normal_equations_pallas)
from watermarking_gpu_tpu_torch.ops import cuda as kernels
from watermarking_gpu_tpu_torch.ops import me as tme
from watermarking_gpu_tpu_torch.ops.cuda import fused
from watermarking_gpu_tpu_torch.ops.me import (solve_coefficients,
                                               solve_coefficients_spd)

torch.set_num_threads(1)

SHAPES = [(40, 96), (37, 83), (3, 40, 96)]


def make_inputs(shape, seed=40961):
    """Frames, watermark and per-frame coefficients as numpy f32; the
    coefficients are the frames' own least-squares predictors, so the
    fields are realistic (zero for a frame too small to solve)."""
    rng = np.random.default_rng(seed)
    frames = np.clip(rng.normal(128, 40, shape), 0, 255).astype(np.float32)
    wm = rng.normal(size=shape[-2:]).astype(np.float32)
    gram = kernels.me_gram_plain(torch.from_numpy(frames.reshape(
        (-1,) + shape[-2:])))
    coeffs, _ = solve_coefficients(gram[:, :8, :8], gram[:, :8, 8])
    return frames, wm, coeffs.numpy().reshape(shape[:-2] + (8,))


def as_batch(array, shape):
    """Torch view of a numpy array with the batch axis that frames of
    ``shape`` (2-D or batched 3-D) may lack."""
    tensor = torch.from_numpy(array)
    return tensor if len(shape) == 3 else tensor[None]


@pytest.mark.parametrize("shape", SHAPES)
def test_me_gram_plain_matches_pallas(shape):
    frames, _, _ = make_inputs(shape)
    gram = kernels.me_gram_plain(as_batch(frames, shape))
    rm, rv = me_normal_equations_pallas(jnp.asarray(frames))
    rm, rv = np.asarray(rm).reshape(-1, 8, 8), np.asarray(rv).reshape(-1, 8)
    np.testing.assert_allclose(gram[:, :8, :8].numpy(), rm, rtol=1e-4)
    np.testing.assert_allclose(gram[:, :8, 8].numpy(), rv, rtol=1e-4)
    np.testing.assert_array_equal(gram.numpy(), gram.transpose(1, 2).numpy())


@pytest.mark.parametrize("mask_type", ["me", "nvf"])
@pytest.mark.parametrize("shape", SHAPES)
def test_embed_field_plain_matches_pallas(shape, mask_type):
    frames, wm, coeffs = make_inputs(shape)
    u_t, s_t, m_t = kernels.embed_field_plain(
        as_batch(frames, shape), torch.from_numpy(wm),
        as_batch(coeffs, shape), mask_type)
    u_j, s_j, m_j = fused_embed_field(jnp.asarray(frames), jnp.asarray(wm),
                                      jnp.asarray(coeffs), mask_type)
    np.testing.assert_allclose(u_t.numpy().reshape(shape), np.asarray(u_j),
                               rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(s_t.numpy().ravel(), np.asarray(s_j).ravel(),
                               rtol=1e-4)
    np.testing.assert_allclose(m_t.numpy().ravel(), np.asarray(m_j).ravel(),
                               rtol=1e-4)


@pytest.mark.parametrize("mask_type", ["me", "nvf"])
@pytest.mark.parametrize("shape", SHAPES)
def test_detect_partials_plain_matches_pallas(shape, mask_type):
    frames, wm, coeffs = make_inputs(shape)
    # detect frames that carry the watermark, so the correlation means
    # something (a u ring built from edge-replicated image rows instead of
    # u's own edge would show here)
    marked = np.clip(frames + 3.0 * wm, 0, 255).astype(np.float32)
    dot, norm_u, norm_z = kernels.detect_partials_plain(
        as_batch(marked, shape), torch.from_numpy(wm),
        as_batch(coeffs, shape), mask_type)
    corr = (dot / torch.sqrt(norm_u * norm_z)).numpy()
    want = np.asarray(fused_detect_tail(jnp.asarray(marked), jnp.asarray(wm),
                                        jnp.asarray(coeffs), mask_type))
    np.testing.assert_allclose(corr, want.ravel(), atol=2e-4)
    assert (corr > 0.05).all()


def test_cpu_detect_counts_no_launch_and_no_pipelined():
    """CPU tensors take the plain detect tail: neither ``launches`` nor
    ``pipelined`` counts; ``launch_counts`` leaves ``pipelined`` out and
    ``reset_launch_counts`` zeroes it. The pipelined schedule is ME
    p = 3's."""
    kernels.detect_partials.pipelined = 3
    before = kernels.launch_counts()
    frames, wm, coeffs = make_inputs((3, 40, 96))
    kernels.detect_partials(torch.from_numpy(frames), torch.from_numpy(wm),
                            torch.from_numpy(coeffs), "me", 3)
    assert kernels.launch_counts() == before
    assert kernels.detect_partials.pipelined == 3
    assert "pipelined" not in kernels.launch_counts()
    kernels.reset_launch_counts()
    assert kernels.detect_partials.pipelined == 0
    assert not any(kernels.launch_counts().values())
    assert [fused.pipelined(mask_type, p) for mask_type in ("me", "nvf")
            for p in (3, 5, 7, 9)] == [True] + [False] * 7


def gram_lag_shape(shape):
    """A (B, rows, cols) shape; rows "strip+1" / "strip-1" are a row more
    or less than the 3x3 lag kernel's strip."""
    batch, rows, cols = shape
    if isinstance(rows, str):
        rows = tme.GRAM_STRIP_ROWS + (1 if rows == "strip+1" else -1)
    return batch, rows, cols


# (64, 130) and (80, 83) take the JAX package's raw Gram kernel, the rest
# its padded one; "strip+1" ends in a strip of one row, 520 and 515 columns
# in a second column block of 8 and 3 columns; (5, 5) and (1, 5) are
# smaller than any strip or tile
@pytest.mark.parametrize("shape", [(2, 64, 130), (2, 80, 83),
                                   (2, "strip+1", 520), (2, "strip-1", 515),
                                   (1, 5, 5), (2, 1, 5)])
def test_gram_lag_plain_versions_match_pallas(shape):
    """The plain versions of the 3x3 Gram's two kernels, chained, against
    the JAX package's Pallas Gram in interpret mode (``me_gram_raw`` where
    its raw geometry holds, as its pipelines route it, else
    ``me_gram_pallas``) and against the direct per-pair sums
    ``gram_direct(image, 3)``; rtol 1e-4."""
    batch, rows, cols = shape = gram_lag_shape(shape)
    frames = np.clip(np.random.default_rng(rows * cols).normal(
        128, 40, shape), 0, 255).astype(np.float32)
    image = torch.from_numpy(frames)
    sums = tme.gram_lags_plain(image)
    strip, n_strips, n_blocks = tme.gram_lag_layout(rows, cols)
    assert sums.shape == (batch, 13, n_strips, n_blocks)
    gram = tme.assemble_lags_plain(sums, image).numpy()
    pad, pallas_strip, rows_padded = pipeline_geometry(rows, cols, "me", 3)
    if raw_mode_ok(rows, pallas_strip, rows_padded):
        want = me_gram_raw(jnp.asarray(frames), rows, cols, RAW_PAD,
                           pallas_strip, rows_padded)
    else:
        want = me_gram_pallas(jnp.asarray(frames))
    np.testing.assert_allclose(gram, np.asarray(want), rtol=1e-4)
    np.testing.assert_allclose(gram, tme.gram_direct(image, 3).numpy(),
                               rtol=1e-4)


@pytest.mark.parametrize("rows", ["strip", "strip+1", "2strip-1"])
def test_gram_lags_add_up_to_the_lag_products(rows):
    """The 3x3 lag kernel's plain output: per strip of GRAM_STRIP_ROWS rows
    and block of GRAM_BLOCK_COLS columns, the sum of each lag product
    P[y, x] P[y + dr, x + dc] (clamped) over the frame's own columns, lags
    in ``lag_plan(3)`` order; added up over strips and blocks it is the
    products' sum over the frame, taken here in float64 with numpy."""
    strip = tme.GRAM_STRIP_ROWS
    rows = {"strip": strip, "strip+1": strip + 1,
            "2strip-1": 2 * strip - 1}[rows]
    cols = tme.GRAM_BLOCK_COLS + 9
    frames = np.clip(np.random.default_rng(rows).normal(
        128, 40, (2, rows, cols)), 0, 255).astype(np.float32)
    sums = tme.gram_lags_plain(torch.from_numpy(frames))
    assert sums.shape == (2, 13, -(-rows // strip), 2)
    ext = np.pad(frames.astype(np.float64), ((0, 0), (2, 2), (2, 2)),
                 mode="edge")
    lags = tme.lag_plan(3)[0]
    assert len(lags) == 13
    for index, (dr, dc) in enumerate(lags):
        product = (ext[:, 2:2 + rows, 2:2 + cols]
                   * ext[:, 2 + dr:2 + dr + rows, 2 + dc:2 + dc + cols])
        np.testing.assert_allclose(sums[:, index].sum(dim=(1, 2)).numpy(),
                                   product.sum(axis=(1, 2)), rtol=1e-5)
        # the first strip and column block alone
        np.testing.assert_allclose(
            sums[:, index, 0, 0].numpy(),
            product[:, :strip, :tme.GRAM_BLOCK_COLS].sum(axis=(1, 2)),
            rtol=1e-5)


def test_constant_frame_gram_is_exactly_singular():
    """A constant frame's lag sums are all the same bits, and the assembly
    takes each correction as a difference before adding it, so its Gram's
    81 entries are the same bits and the unrolled solve flags the frame; the
    other frames of the batch solve."""
    good = np.clip(np.random.default_rng(3).normal(128, 40, (40, 96)), 0,
                   255).astype(np.float32)
    image = torch.from_numpy(np.stack([good, np.full_like(good, 77.0),
                                       good + 1.0]))
    gram = tme.assemble_lags_plain(tme.gram_lags_plain(image), image)
    assert gram[1].unique().numel() == 1
    assert torch.equal(gram[1], tme.gram_direct(image, 3)[1])
    _, valid = solve_coefficients_spd(gram[:, :8, :8], gram[:, :8, 8])
    assert valid.tolist() == [True, False, True]
