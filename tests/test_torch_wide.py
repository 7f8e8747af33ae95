"""The wide-window path (ME and NVF at p = 5, 7, 9) of the port against the
JAX package, with the same numpy frames and watermark fed to both.

* The wide Gram: the port's plain lag partials and assembled Gram against
  the JAX ``ops.me.lag_partials`` / ``me_normal_equations`` (XLA) at every
  shape, and against the Pallas ``me_normal_equations_wide`` (interpret
  mode) at one shape per p — rtol 1e-4, as tests/test_pallas.py holds the
  Pallas kernel to XLA.
* The plain versions of the port's two wide Gram kernels (the lag sums over
  row strips, the assembly), chained, against the JAX
  ``me_normal_equations`` at ragged shapes (rtol 1e-4); the strip sums
  against the lane partials; the kernels' index tables (and the 3x3
  Gram's, at p=3) against ``lag_plan``.
* The wide solve against the JAX ``solve_coefficients_spd_vec`` and
  ``_blocked`` on the same Gram: atol 1e-4 (the bound the JAX package set
  for its wide solves).
* The fused kernels' plain versions against the JAX fused Pallas kernels at
  p=5, and the pipelines at p = 5, 7, 9: ``impl="cuda"`` (plain versions on
  the CPU) against JAX ``impl="pallas"``, ``impl="torch"`` against JAX
  ``impl="xla"``, with the JAX suite's bounds (tests/test_pallas.py:
  pixels atol 0.1, strengths rtol 2e-4, correlations atol 2e-4 for ME and
  3e-4 for NVF).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from watermarking_gpu_tpu.models import Watermark as JaxWatermark
from watermarking_gpu_tpu.ops import me as jme
from watermarking_gpu_tpu.ops import pipelines as jp
from watermarking_gpu_tpu.ops.pallas.fused import (fused_detect_tail,
                                                   fused_embed_field)
from watermarking_gpu_tpu.ops.pallas.me_gram_wide import \
    me_normal_equations_wide
from watermarking_gpu_tpu_torch.models import Watermark
from watermarking_gpu_tpu_torch.ops import cuda as kernels
from watermarking_gpu_tpu_torch.ops import me as tme
from watermarking_gpu_tpu_torch.ops import pipelines as tp
from watermarking_gpu_tpu_torch.ops.neighbors import pad_edge

wide_module = importlib.import_module(
    "watermarking_gpu_tpu_torch.ops.cuda.me_gram_wide")

torch.set_num_threads(1)

SF = 2.55  # strength_factor(40)
WIDE_P = [5, 7, 9]


def frames(shape, seed=40961, std=40):
    rng = np.random.default_rng(seed)
    return np.clip(rng.normal(128, std, shape), 0, 255).astype(np.float32)


def split_gram(gram, k):
    return gram[..., :k, :k].numpy(), gram[..., :k, k].numpy()


@pytest.mark.parametrize("p", WIDE_P)
def test_wide_gram_plain_matches_jax(p):
    h, k = p // 2, p * p - 1
    for shape in [(72, 72), (37, 83), (6 * h, 6 * h), (3, 64, 96)]:
        img = frames(shape, seed=sum(shape))
        img3 = torch.from_numpy(img.reshape((-1,) + shape[-2:]))
        rm, rv = split_gram(kernels.me_gram_wide(img3, p), k)
        rm_j, rv_j = jme.me_normal_equations(jnp.asarray(img), p)
        np.testing.assert_allclose(rm.reshape(rm_j.shape), rm_j, rtol=1e-4)
        np.testing.assert_allclose(rv.reshape(rv_j.shape), rv_j, rtol=1e-4)
        # the kernel's contract: the per-lag lane partials themselves
        ext = jnp.asarray(pad_edge(img3, 3 * h).numpy())
        want = jme.lag_partials(ext, *shape[-2:], p, row0=3 * h, col0=2 * h)
        np.testing.assert_allclose(kernels.lag_partials_plain(img3, p),
                                   want, rtol=1e-4, atol=1e-2)
    # (64, 96) through the JAX Pallas kernel (interpret mode, one shape per
    # p: its compiles are the cost here)
    img = frames((64, 96), seed=7)
    rm, rv = split_gram(kernels.me_gram_wide(torch.from_numpy(img)[None], p),
                        k)
    rm_j, rv_j = me_normal_equations_wide(jnp.asarray(img), p)
    np.testing.assert_allclose(rm[0], rm_j, rtol=1e-4)
    np.testing.assert_allclose(rv[0], rv_j, rtol=1e-4)


@pytest.mark.parametrize("rows", ["6h", 37, 61, "strip+3"])
@pytest.mark.parametrize("p", WIDE_P)
def test_wide_kernel_plain_versions_match_jax(p, rows):
    """The plain versions of the wide Gram's two kernels, chained (the CPU
    route of ``me_gram_wide``), against the JAX ``me_normal_equations`` at
    ragged shapes: "strip+3" rows end in a strip of 3 rows at the default
    strip height (fewer than 2h), 83 and 130 columns in a part-filled lane
    block. rtol 1e-4."""
    h, k = p // 2, p * p - 1
    if rows == "6h":
        rows = 6 * h
    elif rows == "strip+3":
        rows = tme.WIDE_STRIP_ROWS[p] + 3
        assert rows % tme.wide_lag_layout(rows, 130, p)[0] == 3
    for cols in (6 * h, 83, 130):
        img = frames((2, rows, cols), seed=rows * cols + p)
        image = torch.from_numpy(img)
        sums, edges = tme.lag_strips_plain(image, p)
        gram = tme.assemble_strips_plain(sums, edges,
                                         *tme.frame_banks(image, p), p)
        assert torch.equal(kernels.me_gram_wide(image, p), gram)
        rm, rv = split_gram(gram, k)
        rm_j, rv_j = jme.me_normal_equations(jnp.asarray(img), p)
        np.testing.assert_allclose(rm, rm_j, rtol=1e-4)
        np.testing.assert_allclose(rv, rv_j, rtol=1e-4)


@pytest.mark.parametrize("last", [0, 1, "2h-1"])
@pytest.mark.parametrize("p", WIDE_P)
def test_lag_strips_add_up_to_the_lane_partials(p, last):
    """The lag kernel's plain output, summed over strips and lane blocks, is
    the lane partials' full sum, and its edge lanes summed over strips are
    the partials' 2h left and 2h right lanes; at the kernel's strip height
    over two whole strips (``last`` 0) and over a strip and a last one of 1
    or 2h - 1 rows, 300 columns (300 + 2h lanes: 3 lane blocks)."""
    h = p // 2
    strip = tme.WIDE_STRIP_ROWS[p]
    rows = (2 * strip if last == 0
            else strip + (1 if last == 1 else 2 * h - 1))
    image = torch.from_numpy(frames((1, rows, 300), seed=p))
    partials = tme.lag_partials_plain(image, p)
    n_lags = partials.shape[1]
    edge_lanes = torch.cat([partials[..., :2 * h], partials[..., -2 * h:]],
                           dim=-1)
    sums, edges = tme.lag_strips_plain(image, p)
    assert tme.wide_lag_layout(rows, 300, p) == (strip, 2, 3)
    assert sums.shape == (1, n_lags, 2, 3)
    assert edges.shape == (1, n_lags, 2, 4 * h)
    torch.testing.assert_close(sums.sum(dim=(2, 3)), partials.sum(-1),
                               rtol=1e-5, atol=0)
    torch.testing.assert_close(edges.sum(dim=2), edge_lanes, rtol=1e-5,
                               atol=0)


@pytest.mark.parametrize("p", [3, *WIDE_P])
def test_wide_kernel_tables_cover_the_gram(p):
    """The kernels' tables from ``lag_plan`` (at p=3 the 3x3 Gram's): the
    lag kernel's index of each (dc, dr) hits every canonical lag once and
    nothing else, and the assembly kernel's pairs, grouped by lag, cover
    each cell of the Gram's upper triangle once."""
    h, n = p // 2, p * p
    tables = {name: t.tolist() for name, t in
              wide_module._tables(p, torch.device("cpu")).items()}
    lags = tme.lag_plan(p)[0]
    assert tables["lags"] == [list(lag) for lag in lags]
    index = tables["lag_index"]
    for dc in range(-2 * h, 2 * h + 1):
        for dr in range(2 * h + 1):
            want = lags.index((dr, dc)) if (dr, dc) in lags else -1
            assert index[(dc + 2 * h) * (2 * h + 1) + dr] == want
            assert (want == -1) == (dr == 0 and dc < 0)
    start, pairs = tables["pair_start"], tables["pairs"]
    assert start[0] == 0 and start[-1] == len(pairs) == n * (n + 1) // 2
    _, pair_lag, pair_ar, pair_ai, pair_index = tme.lag_plan(p)
    cells = set()
    for lag in range(len(lags)):
        for row, column, ar, ai in pairs[start[lag]:start[lag + 1]]:
            pair = pair_index[row][column]
            assert row <= column
            assert (pair_lag[pair], pair_ar[pair], pair_ai[pair]) == (lag, ar,
                                                                      ai)
            cells.add((row, column))
    assert len(cells) == len(pairs)


@pytest.mark.parametrize("p", WIDE_P)
def test_wide_gram_below_lag_geometry_takes_direct_sums(p):
    """Frames under 6h rows or columns take the direct per-pair sums (the
    JAX package's own rule); the Gram still matches JAX."""
    h, k = p // 2, p * p - 1
    for shape in [(6 * h - 1, 96), (20, 6 * h - 1)]:
        assert not tme.wide_lag_geometry(*shape, p)
        img = torch.from_numpy(frames((2,) + shape, seed=3))
        gram = kernels.me_gram_wide(img, p)
        torch.testing.assert_close(gram, tme.gram_direct(img, p), rtol=0,
                                   atol=0)
        rm_j, rv_j = jme.me_normal_equations(jnp.asarray(img.numpy()), p)
        rm, rv = split_gram(gram, k)
        np.testing.assert_allclose(rm, rm_j, rtol=1e-4)
        np.testing.assert_allclose(rv, rv_j, rtol=1e-4)
    assert tme.wide_lag_geometry(6 * h, 6 * h, p)
    assert not tme.wide_lag_geometry(96, 96, 3)


@pytest.mark.parametrize("p", WIDE_P)
def test_wide_solve_matches_jax(p):
    """The library Cholesky against both JAX wide solves on the same Gram;
    a constant frame's rank-1 Gram comes back invalid with zero
    coefficients, beside a good frame."""
    stack = np.stack([frames((40, 96), seed=p),
                      np.full((40, 96), 77.0, np.float32),
                      frames((40, 96), seed=p + 1, std=20)])
    rm, rv = jme.me_normal_equations(jnp.asarray(stack), p)
    coeffs, valid = tme.solve_coefficients_spd_wide(
        torch.from_numpy(np.array(rm)), torch.from_numpy(np.array(rv)))
    assert valid.tolist() == [True, False, True]
    assert not coeffs[1].any()
    for solve in (jme.solve_coefficients_spd_vec,
                  jme.solve_coefficients_spd_blocked):
        c_j, v_j = solve(rm, rv)
        assert np.asarray(v_j).tolist() == valid.tolist()
        np.testing.assert_allclose(coeffs.numpy(), c_j, atol=1e-4)


@pytest.mark.parametrize("mask_type", ["me", "nvf"])
def test_fused_plain_versions_match_pallas_at_p5(mask_type):
    p = 5
    img = frames((2, 40, 96))
    wm = np.random.default_rng(1).normal(size=(40, 96)).astype(np.float32)
    coeffs, _ = tp._analysis(torch.from_numpy(img),
                             p if mask_type == "me" else 3)
    u, s, m = kernels.embed_field_plain(torch.from_numpy(img),
                                        torch.from_numpy(wm), coeffs,
                                        mask_type, p)
    u_j, s_j, m_j = fused_embed_field(jnp.asarray(img), jnp.asarray(wm),
                                      jnp.asarray(coeffs.numpy()), mask_type,
                                      p)
    np.testing.assert_allclose(u.numpy(), u_j, rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(s.numpy(), s_j, rtol=1e-4)
    np.testing.assert_allclose(m.numpy(), m_j, rtol=1e-4)
    marked = np.clip(img + 3.0 * wm, 0, 255).astype(np.float32)
    dot, norm_u, norm_z = kernels.detect_partials_plain(
        torch.from_numpy(marked), torch.from_numpy(wm), coeffs, mask_type, p)
    corr = (dot / torch.sqrt(norm_u * norm_z)).numpy()
    want = fused_detect_tail(jnp.asarray(marked), jnp.asarray(wm),
                             jnp.asarray(coeffs.numpy()), mask_type, p)
    np.testing.assert_allclose(corr, want, atol=2e-4)
    assert (corr > 0.05).all()


def round_trip(module, to_array, img, wm, mask_type, p, impl):
    marked, strength = module.embed_pipeline(to_array(img), to_array(img),
                                             to_array(wm), SF, mask_type, p=p,
                                             impl=impl)
    corr = module.detect_pipeline(marked, to_array(wm), mask_type, p=p,
                                  impl=impl)
    return tuple(np.asarray(a) for a in (marked, strength, corr))


@pytest.mark.parametrize("mask_type", ["me", "nvf"])
@pytest.mark.parametrize("p,rows", [(5, 40), (7, 40), (9, 40), (9, 20)])
def test_wide_pipelines_match_jax(p, rows, mask_type):
    """p=9 at 20 rows sits below the lag geometry: the JAX pipelines run
    their XLA formulation there, the port the direct Gram sums. The JAX
    Pallas route runs in interpret mode at one shape per p (40 rows): its
    compiles are the cost here."""
    img = frames((rows, 96), seed=p * rows, std=30)
    wm = np.random.default_rng(p).normal(size=(rows, 96)).astype(np.float32)
    corr_atol = 2e-4 if mask_type == "me" else 3e-4
    pairs = [("torch", "xla")] + ([("cuda", "pallas")] if rows == 40 else [])
    for impl, jax_impl in pairs:
        got = round_trip(tp, torch.from_numpy, img, wm, mask_type, p, impl)
        want = round_trip(jp, jnp.asarray, img, wm, mask_type, p, jax_impl)
        np.testing.assert_allclose(got[0], want[0], atol=0.1)
        np.testing.assert_allclose(got[1], want[1], rtol=2e-4)
        np.testing.assert_allclose(got[2], want[2], atol=corr_atol)
        assert got[2] > 0.02


def test_watermark_from_state_matches_jax_at_p5():
    frame = frames((40, 96), seed=5)
    ref = JaxWatermark(40, 96, 7, p=5, psnr=40.0, impl="xla")
    port = Watermark.from_state(
        {"rows": ref.rows, "cols": ref.cols, "p": ref.p, "psnr": ref.psnr,
         "random_matrix": np.asarray(ref.random_matrix)}, device="cpu")
    assert port.p == 5 and port.impl == "cuda"
    for mask_type in ("me", "nvf"):
        marked, strength = port.embed(frame, mask_type=mask_type)
        corr = port.detect(marked, mask_type)
        marked_j, strength_j = ref.embed(frame, mask_type=mask_type)
        corr_j = ref.detect(marked_j, mask_type)
        np.testing.assert_allclose(marked.numpy(), marked_j, atol=0.1)
        np.testing.assert_allclose(strength.numpy(), strength_j, rtol=2e-4)
        np.testing.assert_allclose(corr.numpy(), corr_j, atol=2e-4)
